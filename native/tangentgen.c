/* C ABI wrapper over vendored MikkTSpace for indexed triangle meshes.
 *
 * Role of the reference's TangentGen MikkTSpace adapter
 * (reference: src/assets/TangentGen.mm:8-110): per-corner tangents from
 * the spec implementation, scattered to the corner's vertex index (the
 * adapter convention for indexed meshes). The UV-derivative fallback
 * lives in metal_pathtracer/scene/tangent.py.
 */

#include <string.h>

#include "mikktspace/mikktspace.h"

typedef struct {
    int n_faces;
    const float* positions; /* (V,3) */
    const float* normals;   /* (V,3) */
    const float* uvs;       /* (V,2) */
    const int* faces;       /* (F,3) */
    float* out;             /* (V,4) tangent xyz + sign */
} MeshCtx;

static int get_num_faces(const SMikkTSpaceContext* c) {
    return ((const MeshCtx*)c->m_pUserData)->n_faces;
}
static int get_num_verts(const SMikkTSpaceContext* c, const int f) {
    (void)c;
    (void)f;
    return 3;
}
static int vert_index(const SMikkTSpaceContext* c, int f, int v) {
    const MeshCtx* m = (const MeshCtx*)c->m_pUserData;
    return m->faces[3 * f + v];
}
static void get_position(const SMikkTSpaceContext* c, float out[],
                         const int f, const int v) {
    const MeshCtx* m = (const MeshCtx*)c->m_pUserData;
    memcpy(out, m->positions + 3 * vert_index(c, f, v), 3 * sizeof(float));
}
static void get_normal(const SMikkTSpaceContext* c, float out[], const int f,
                       const int v) {
    const MeshCtx* m = (const MeshCtx*)c->m_pUserData;
    memcpy(out, m->normals + 3 * vert_index(c, f, v), 3 * sizeof(float));
}
static void get_texcoord(const SMikkTSpaceContext* c, float out[],
                         const int f, const int v) {
    const MeshCtx* m = (const MeshCtx*)c->m_pUserData;
    memcpy(out, m->uvs + 2 * vert_index(c, f, v), 2 * sizeof(float));
}
static void set_tspace(const SMikkTSpaceContext* c, const float t[],
                       const float sign, const int f, const int v) {
    MeshCtx* m = (MeshCtx*)c->m_pUserData;
    float* dst = m->out + 4 * vert_index(c, f, v);
    dst[0] = t[0];
    dst[1] = t[1];
    dst[2] = t[2];
    dst[3] = sign;
}

/* returns 1 on success, 0 on MikkTSpace failure */
int mikkt_generate_tangents(int n_faces, const float* positions,
                            const float* normals, const float* uvs,
                            const int* faces, float* out_tangents) {
    MeshCtx mesh = {n_faces, positions, normals, uvs, faces, out_tangents};
    SMikkTSpaceInterface iface;
    memset(&iface, 0, sizeof(iface));
    iface.m_getNumFaces = get_num_faces;
    iface.m_getNumVerticesOfFace = get_num_verts;
    iface.m_getPosition = get_position;
    iface.m_getNormal = get_normal;
    iface.m_getTexCoord = get_texcoord;
    iface.m_setTSpaceBasic = set_tspace;
    SMikkTSpaceContext ctx = {&iface, &mesh};
    return genTangSpaceDefault(&ctx) ? 1 : 0;
}
