// CPU oracle path tracer — the framework's independent parity reference.
//
// Plays the role the Embree backend plays in the reference renderer
// (reference: src/headless/EmbreeHeadlessRenderer.mm — a complete,
// independent CPU implementation of the same material/sampling model used
// as the RMSE gate). This implementation is written against the same
// behavioral spec as the JAX integrator (ops/integrator.py): identical PCG
// RNG and per-pixel seeding, identical BSDF math for all 8 material types
// (lambert / GGX conductor / exact-Fresnel dielectric / diffuse light /
// plastic / subsurface separable + random walk / carpaint / PBR
// metallic-roughness with rough transmission), rect-light NEE + env
// alias-table NEE with MIS, Beer-Lambert medium stack, firefly clamps and
// Russian roulette.
//
// Tile-parallel over std::thread with an atomic work index, 16x16 tiles
// (the reference backend's scheduling, EmbreeHeadlessRenderer.mm:2538+).
//
// C ABI (ctypes). Parity notes: most types are RNG-stream-exact vs the JAX
// integrator (RMSE ~1e-5). Carpaint-with-flakes and random-walk SSS agree
// statistically, not bitwise: the flake spatial hash and grazing-angle TIR
// decisions amplify last-bit position differences between XLA and C++.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" int build_bvh_sah(int, const float*, float*, float*, int32_t*,
                             int32_t*, int32_t*, int32_t*, int, int);

namespace {

constexpr float kPi = 3.14159265358979323846f;
constexpr float kInfinity = 1e20f;
constexpr float kEpsilon = 1e-3f;
constexpr float kRayOriginEpsilon = 1e-4f;
constexpr float kMisMin = 1.0e-4f;
constexpr float kMisMax = 0.9999f;
constexpr int kMaxMedium = 8;

struct V3 {
    float x = 0, y = 0, z = 0;
};
inline V3 operator+(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
inline V3 operator-(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
inline V3 operator*(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
inline V3 operator*(float s, V3 a) { return a * s; }
inline V3 operator*(V3 a, V3 b) { return {a.x * b.x, a.y * b.y, a.z * b.z}; }
inline V3 operator/(V3 a, float s) { return {a.x / s, a.y / s, a.z / s}; }
inline float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
inline V3 cross(V3 a, V3 b) {
    return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
inline float length(V3 a) { return std::sqrt(dot(a, a)); }
inline V3 normalize(V3 a) {
    float l = length(a);
    return l > 0 ? a / l : V3{0, 0, 0};
}
inline V3 vmin0(V3 a) { return {std::max(a.x, 0.f), std::max(a.y, 0.f), std::max(a.z, 0.f)}; }
inline float maxc(V3 a) { return std::max(a.x, std::max(a.y, a.z)); }
inline bool finite3(V3 a) {
    return std::isfinite(a.x) && std::isfinite(a.y) && std::isfinite(a.z);
}
inline float luminance(V3 c) {
    return 0.2126f * c.x + 0.7152f * c.y + 0.0722f * c.z;
}
inline V3 vexp(V3 a) { return {std::exp(a.x), std::exp(a.y), std::exp(a.z)}; }
inline V3 reflect(V3 v, V3 n) { return v - 2.0f * dot(v, n) * n; }
inline V3 refract(V3 v, V3 n, float eta) {
    float cosi = -dot(v, n);
    float k = 1.0f - eta * eta * (1.0f - cosi * cosi);
    if (k < 0.0f) return {0, 0, 0};
    return eta * v + (eta * cosi - std::sqrt(k)) * n;
}

// ---- RNG: bit-identical to ops/rng.py / pathtrace.metal:55-64 -----------
inline uint32_t pcg_hash(uint32_t s) {
    s = s * 747796405u + 2891336453u;
    uint32_t w = ((s >> ((s >> 28u) + 4u)) ^ s) * 277803737u;
    return (w >> 22u) ^ w;
}
inline float rand_uniform(uint32_t& s) {
    s = pcg_hash(s);
    return static_cast<float>(s) / 4294967296.0f;
}
inline void disk_sample(uint32_t& s, float& ox, float& oy) {
    while (true) {
        float a = rand_uniform(s) * 2.0f - 1.0f;
        float b = rand_uniform(s) * 2.0f - 1.0f;
        if (a * a + b * b < 1.0f) {
            ox = a;
            oy = b;
            return;
        }
    }
}
inline void build_onb(V3 n, V3& t, V3& b) {
    V3 up = std::fabs(n.z) < 0.999f ? V3{0, 0, 1} : V3{1, 0, 0};
    t = normalize(cross(up, n));
    b = cross(n, t);
}
inline V3 to_world(V3 local, V3 n) {
    V3 t, b;
    build_onb(n, t, b);
    return local.x * t + local.y * b + local.z * n;
}
inline V3 cosine_hemisphere(uint32_t& s) {
    float r1 = rand_uniform(s);
    float r2 = rand_uniform(s);
    float phi = 2.0f * kPi * r2;
    float r = std::sqrt(std::max(r1, 0.0f));
    return {std::cos(phi) * r, std::sin(phi) * r,
            std::sqrt(std::max(1.0f - r1, 0.0f))};
}

// ---- scene data ----------------------------------------------------------
struct Material {
    V3 base_color;
    float roughness;
    int type;
    float eta;
    float thin;
    V3 emission;
    float emission_env;
    V3 conductor_eta, conductor_k;
    float has_conductor;
    V3 sigma_a;  // dielectric absorption
    float coat_roughness, coat_thickness, coat_sample_weight, coat_fresnel_avg;
    V3 coat_tint, coat_absorption;
    float coat_ior;
    // PBR metallic-roughness (ops/pbr.py; reference pathtrace.metal:4632-4945)
    float pbr_metallic, pbr_transmission, pbr_thickness, pbr_double_sided;
    // CarPaint (ops/carpaint.py; reference pathtrace.metal:3300-3536)
    float cp_base_metallic, cp_base_roughness, cp_flake_scale;
    float cp_flake_sample_weight, cp_flake_roughness, cp_flake_anisotropy;
    float cp_flake_normal_strength;
    V3 cp_base_eta, cp_base_k;
    float cp_has_base_conductor;
    // Subsurface (ops/sss.py; reference pathtrace.metal:3912-4310)
    V3 ss_a, ss_s;
    float ss_mfp, ss_g, ss_method, ss_coat, ss_override;
    int base_tex = -1;  // base-color texture id (-1 = none)
    // full PBR texture slot set (ops/pbr_textures.py; reference
    // pathtrace.metal:5919-6424) — ids into the shared pool, -1 = none
    int orm_tex = -1, normal_tex = -1, occ_tex = -1, em_tex = -1,
        trans_tex = -1;
    float occlusion_strength = 1.0f, normal_scale = 1.0f;
    int mat_flags = 0;        // bit 0: disable ORM
    float occlusion = 1.0f;   // derived per hit by textured_material
};

struct Scene {
    int n_spheres = 0;
    const float* sph = nullptr;  // (S,4) center+radius
    const int* sph_mat = nullptr;
    int n_rects = 0;
    const float* rect = nullptr;  // (R,15) corner eU eV invU invV n plane
    const int* rect_mat = nullptr;
    const int* rect_two_sided = nullptr;
    int n_tris = 0;
    const float* tri = nullptr;  // (T,9)
    const int* tri_mat = nullptr;
    std::vector<Material> mats;
    std::vector<int> light_rects;
    // env
    int env_w = 0, env_h = 0;
    const float* env_texels = nullptr;
    const float* marg_thresh = nullptr;
    const int* marg_alias = nullptr;
    const float* cond_thresh = nullptr;
    const int* cond_alias = nullptr;
    const float* env_pdf = nullptr;
    float env_rotation = 0.0f, env_intensity = 1.0f;
    // base-color textures (uniform tex_size^2 RGB linear — the JAX side's
    // ops/textures.py resampled pool; oracle samples bilinear at LOD 0)
    const float* tri_uv = nullptr;   // (T,6) uv per corner
    const float* tri_tan = nullptr;  // (T,12) per-corner tangents
    int n_textures = 0, tex_size = 0;
    const float* tex_data = nullptr;  // (n, ts, ts, 3)
    const int* tex_wrap = nullptr;    // (n,2) 0=repeat 1=clamp 2=mirror
    // tri BVH (exit-link layout, built on the fly)
    std::vector<float> bvh_min, bvh_max;
    std::vector<int> bvh_exit, bvh_off, bvh_cnt, bvh_prims;
};

struct Hit {
    bool hit = false;
    float t = kInfinity;
    V3 point, normal;
    bool front = false, two_sided = false;
    int mat = 0;
    int prim_type = 0;  // 1 sphere 2 rect 3 tri
    int prim = -1;
    float bu = 0, bv = 0;  // triangle barycentrics (MT u,v)
};

struct Clamps {
    float factor, floor_, throughput, max_contribution, enabled;
};

// ---- base-color texture sampling (matches ops/textures.py _bilinear:
// pixel-center -0.5 offset, repeat/clamp/mirror addressing, LOD 0) ------
static inline int tex_addr(int coord, int size, int mode) {
    if (mode == 1) return std::min(std::max(coord, 0), size - 1);
    if (mode == 2) {
        int p = 2 * size;
        int m = ((coord % p) + p) % p;
        return m < size ? m : p - 1 - m;
    }
    int m = coord % size;
    return m < 0 ? m + size : m;
}

static V3 sample_base_tex(const Scene& sc, int tid, float u, float v) {
    int ts = sc.tex_size;
    float x = u * ts - 0.5f, y = v * ts - 0.5f;
    float x0f = std::floor(x), y0f = std::floor(y);
    float fx = x - x0f, fy = y - y0f;
    int ws = sc.tex_wrap ? sc.tex_wrap[2 * tid] : 0;
    int wt = sc.tex_wrap ? sc.tex_wrap[2 * tid + 1] : 0;
    int x0 = tex_addr((int)x0f, ts, ws), x1 = tex_addr((int)x0f + 1, ts, ws);
    int y0 = tex_addr((int)y0f, ts, wt), y1 = tex_addr((int)y0f + 1, ts, wt);
    const float* T = sc.tex_data + (size_t)tid * ts * ts * 3;
    auto texel = [&](int yy, int xx) {
        const float* q = T + ((size_t)yy * ts + xx) * 3;
        return V3{q[0], q[1], q[2]};
    };
    V3 top = texel(y0, x0) * (1 - fx) + texel(y0, x1) * fx;
    V3 bot = texel(y1, x0) * (1 - fx) + texel(y1, x1) * fx;
    return top * (1 - fy) + bot * fy;
}

// Texturing applies to PBR materials only (the JAX side gates textures on
// the pbr lane — ops/pbr_textures.py:331). Implements the full slot set:
// base / ORM / normal / occlusion / emissive / transmission
// (ops/pbr_textures.py apply_pbr_textures; reference :5919-6424), bilinear
// at LOD 0. `n_out` receives the normal-mapped shading normal.
static Material textured_material(const Scene& sc, const Hit& rec,
                                  V3& n_out) {
    Material m = sc.mats[std::min(rec.mat, (int)sc.mats.size() - 1)];
    n_out = rec.normal;
    if (m.type != 7 || rec.prim_type != 3 || !sc.tri_uv || !sc.tex_data)
        return m;
    auto ok = [&](int t) { return t >= 0 && t < sc.n_textures; };
    const float* uv = sc.tri_uv + 6 * rec.prim;
    float w0 = 1.0f - rec.bu - rec.bv;
    float uu = w0 * uv[0] + rec.bu * uv[2] + rec.bv * uv[4];
    float vv = w0 * uv[1] + rec.bu * uv[3] + rec.bv * uv[5];

    if (ok(m.base_tex))
        m.base_color = m.base_color * sample_base_tex(sc, m.base_tex, uu, vv);

    bool disable_orm = (m.mat_flags & 1) != 0;
    if (ok(m.orm_tex) && !disable_orm) {
        V3 orm = sample_base_tex(sc, m.orm_tex, uu, vv);
        m.pbr_metallic = std::clamp(
            orm.z * std::clamp(m.pbr_metallic, 0.f, 1.f), 0.f, 1.f);
        m.roughness = std::clamp(
            orm.y * std::clamp(m.roughness, 0.f, 1.f), 0.f, 1.f);
    }
    if (ok(m.trans_tex)) {
        V3 tr = sample_base_tex(sc, m.trans_tex, uu, vv);
        m.pbr_transmission = std::clamp(
            std::clamp(m.pbr_transmission, 0.f, 1.f) * tr.x, 0.f, 1.f);
    }
    if (ok(m.occ_tex) && !disable_orm) {
        V3 occ = sample_base_tex(sc, m.occ_tex, uu, vv);
        m.occlusion = 1.0f + (occ.x - 1.0f)
            * std::clamp(m.occlusion_strength, 0.f, 1.f);
    }
    if (ok(m.em_tex))
        m.emission = m.emission * sample_base_tex(sc, m.em_tex, uu, vv);

    if (ok(m.normal_tex) && m.normal_scale > 1e-4f) {
        V3 nm = sample_base_tex(sc, m.normal_tex, uu, vv) * 2.0f - V3{1, 1, 1};
        nm.x *= m.normal_scale;
        nm.y *= m.normal_scale;
        float normal_length = std::sqrt(std::max(dot(nm, nm), 1e-12f));
        float xy2 = nm.x * nm.x + nm.y * nm.y;
        nm.z = std::sqrt(std::max(1.0f - xy2, 0.0f));
        float nl = std::sqrt(std::max(dot(nm, nm), 0.0f));
        if (nl > 0) nm = nm * (1.0f / nl);
        // tangent basis: interpolated vertex tangent (Gram-Schmidt) or ONB
        V3 n = rec.normal;
        V3 t, b;
        bool used_vertex = false;
        if (sc.tri_tan) {
            const float* tn = sc.tri_tan + 12 * rec.prim;
            V3 t_raw = {w0 * tn[0] + rec.bu * tn[4] + rec.bv * tn[8],
                        w0 * tn[1] + rec.bu * tn[5] + rec.bv * tn[9],
                        w0 * tn[2] + rec.bu * tn[6] + rec.bv * tn[10]};
            float sign_w = w0 * tn[3] + rec.bu * tn[7] + rec.bv * tn[11];
            bool trust = std::fabs(sign_w) > 0.5f && dot(t_raw, t_raw) > 1e-6f;
            V3 t_gs = t_raw - n * dot(n, t_raw);
            if (trust && dot(t_gs, t_gs) > 1e-6f) {
                t = normalize(t_gs);
                b = normalize(cross(n, t)) * (sign_w < 0.0f ? -1.0f : 1.0f);
                used_vertex = true;
            }
        }
        if (!used_vertex) build_onb(n, t, b);
        V3 mapped = normalize(t * nm.x + b * nm.y + n * nm.z);
        if (dot(mapped, rec.normal) < 0.0f) mapped = mapped * -1.0f;
        n_out = mapped;
        // Toksvig roughness widening from normal shortening (:6359-6395)
        float tok = std::max(
            (1.0f - normal_length) / std::max(normal_length, 1e-6f), 0.0f);
        m.roughness = std::clamp(
            std::sqrt(m.roughness * m.roughness + tok), 0.0f, 1.0f);
    }
    return m;
}

// ---- intersection (reference math: pathtrace.metal:1239-1319, 544-592) --
bool hit_spheres(const Scene& sc, V3 o, V3 d, float tmin, float tmax, Hit& out) {
    bool any = false;
    float closest = tmax;
    for (int i = 0; i < sc.n_spheres; ++i) {
        V3 c = {sc.sph[4 * i], sc.sph[4 * i + 1], sc.sph[4 * i + 2]};
        float r = sc.sph[4 * i + 3];
        V3 oc = o - c;
        float a = dot(d, d);
        float hb = dot(oc, d);
        float cc = dot(oc, oc) - r * r;
        float disc = hb * hb - a * cc;
        if (disc < 0) continue;
        float sq = std::sqrt(disc);
        float root = (-hb - sq) / a;
        if (root < tmin || root > closest) {
            root = (-hb + sq) / a;
            if (root < tmin || root > closest) continue;
        }
        closest = root;
        out.hit = true;
        out.t = root;
        out.point = o + d * root;
        V3 outward = (out.point - c) / r;
        out.front = dot(d, outward) < 0;
        out.normal = out.front ? outward : outward * -1.0f;
        out.two_sided = true;
        out.mat = sc.sph_mat[i];
        out.prim_type = 1;
        out.prim = i;
        any = true;
    }
    return any;
}

bool hit_rects(const Scene& sc, V3 o, V3 d, float tmin, float tmax, Hit& out) {
    bool any = false;
    float closest = out.hit ? out.t : tmax;
    for (int i = 0; i < sc.n_rects; ++i) {
        const float* r = sc.rect + 15 * i;
        V3 n = {r[11], r[12], r[13]};
        float denom = dot(n, d);
        if (std::fabs(denom) < 1e-6f) continue;
        float t = (r[14] - dot(n, o)) / denom;
        if (t < tmin || t > closest) continue;
        V3 p = o + d * t;
        V3 rel = p - V3{r[0], r[1], r[2]};
        float u = dot(rel, {r[3], r[4], r[5]}) * r[9];
        float v = dot(rel, {r[6], r[7], r[8]}) * r[10];
        if (u < 0 || u > 1 || v < 0 || v > 1) continue;
        closest = t;
        out.hit = true;
        out.t = t;
        out.point = p;
        out.front = denom < 0;
        out.normal = out.front ? n : n * -1.0f;
        out.two_sided = sc.rect_two_sided[i] != 0;
        out.mat = sc.rect_mat[i];
        out.prim_type = 2;
        out.prim = i;
        any = true;
    }
    return any;
}

bool hit_tris(const Scene& sc, V3 o, V3 d, float tmin, float tmax,
              int exclude, Hit& out) {
    if (sc.n_tris == 0) return false;
    bool any = false;
    float closest = out.hit ? out.t : tmax;
    V3 inv = {1.0f / (std::fabs(d.x) < 1e-20f ? 1e-20f : d.x),
              1.0f / (std::fabs(d.y) < 1e-20f ? 1e-20f : d.y),
              1.0f / (std::fabs(d.z) < 1e-20f ? 1e-20f : d.z)};
    int node = 0;
    const int n_nodes = static_cast<int>(sc.bvh_off.size());
    while (node < n_nodes) {
        const float* bmin = &sc.bvh_min[3 * node];
        const float* bmax = &sc.bvh_max[3 * node];
        float t0x = (bmin[0] - o.x) * inv.x, t1x = (bmax[0] - o.x) * inv.x;
        float t0y = (bmin[1] - o.y) * inv.y, t1y = (bmax[1] - o.y) * inv.y;
        float t0z = (bmin[2] - o.z) * inv.z, t1z = (bmax[2] - o.z) * inv.z;
        float tn = std::max({std::min(t0x, t1x), std::min(t0y, t1y),
                             std::min(t0z, t1z), tmin});
        float tf = std::min({std::max(t0x, t1x), std::max(t0y, t1y),
                             std::max(t0z, t1z), closest});
        if (tf < tn) {
            node = sc.bvh_exit[node];
            continue;
        }
        if (sc.bvh_cnt[node] > 0) {
            for (int k = 0; k < sc.bvh_cnt[node]; ++k) {
                int ti = sc.bvh_prims[sc.bvh_off[node] + k];
                if (ti == exclude) continue;
                const float* tv = sc.tri + 9 * ti;
                V3 v0 = {tv[0], tv[1], tv[2]};
                V3 e1 = V3{tv[3], tv[4], tv[5]} - v0;
                V3 e2 = V3{tv[6], tv[7], tv[8]} - v0;
                V3 pv = cross(d, e2);
                float det = dot(e1, pv);
                if (std::fabs(det) < 1e-8f) continue;
                float invd = 1.0f / det;
                V3 tvv = o - v0;
                float u = dot(tvv, pv) * invd;
                if (u < 0 || u > 1) continue;
                V3 qv = cross(tvv, e1);
                float v = dot(d, qv) * invd;
                if (v < 0 || u + v > 1) continue;
                float t = dot(e2, qv) * invd;
                if (t < tmin || t > closest) continue;
                closest = t;
                out.hit = true;
                out.t = t;
                out.point = o + d * t;
                V3 gn = normalize(cross(e1, e2));
                out.front = dot(d, gn) < 0;
                out.normal = out.front ? gn : gn * -1.0f;
                out.two_sided = false;
                out.mat = sc.tri_mat[ti];
                out.prim_type = 3;
                out.prim = ti;
                out.bu = u;
                out.bv = v;
                any = true;
            }
            node = sc.bvh_exit[node];
        } else {
            node = node + 1;
        }
    }
    return any;
}

bool trace(const Scene& sc, V3 o, V3 d, float tmin, float tmax,
           int exclude_tri, Hit& out) {
    out = Hit{};
    out.t = tmax;
    bool a = hit_spheres(sc, o, d, tmin, tmax, out);
    bool b = hit_rects(sc, o, d, tmin, tmax, out);
    bool c = hit_tris(sc, o, d, tmin, tmax, exclude_tri, out);
    return a || b || c;
}

V3 offset_origin(const Hit& h, V3 dir) {
    V3 n = h.normal;
    float sign = dot(dir, n) >= 0 ? 1.0f : -1.0f;
    float dist = std::max(std::fabs(h.t) * 1e-4f, kRayOriginEpsilon);
    return h.point + n * (sign * dist) + dir * (kRayOriginEpsilon * 0.5f);
}

// ---- clamps (reference: pathtrace.metal clamp_*) -------------------------
V3 clamp_contribution(V3 tp, V3 c, const Clamps& p) {
    V3 comb = tp * c;
    if (!finite3(comb)) return {0, 0, 0};
    V3 pos = vmin0(comb);
    if (p.enabled < 0.5f) return pos;
    float lum = luminance(pos);
    float tl = luminance(vmin0(tp));
    float ml = std::max(tl * p.factor, p.floor_);
    if (p.max_contribution > 0) ml = std::max(ml, p.max_contribution);
    if (lum > ml && lum > 0) {
        comb = comb * (ml / std::max(lum, 1e-6f));
        pos = vmin0(comb);
    }
    return pos;
}
V3 clamp_throughput(V3 tp, const Clamps& p) {
    if (!finite3(tp)) return {0, 0, 0};
    if (p.enabled < 0.5f || p.throughput <= 0) return tp;
    float lum = luminance(vmin0(tp));
    if (lum > p.throughput && lum > 0)
        return tp * (p.throughput / std::max(lum, 1e-6f));
    return tp;
}

// ---- Fresnel / GGX (reference: pathtrace.metal:3645-3911) ----------------
float fresnel_dielectric(float ci, float etai, float etat, float& cost) {
    ci = std::clamp(ci, -1.0f, 1.0f);
    float aci = std::fabs(ci);
    float s2i = std::max(0.0f, 1.0f - aci * aci);
    float eta = etai / etat;
    float s2t = eta * eta * s2i;
    if (s2t >= 1.0f) {
        cost = 0;
        return 1.0f;
    }
    cost = std::sqrt(std::max(1.0f - s2t, 0.0f));
    float rs = (etai * aci - etat * cost) / (etai * aci + etat * cost);
    float rp = (etat * aci - etai * cost) / (etat * aci + etai * cost);
    return 0.5f * (rs * rs + rp * rp);
}
V3 fresnel_conductor(float ci, V3 eta, V3 k) {
    ci = std::clamp(ci, -1.0f, 1.0f);
    float c2 = ci * ci, s2 = std::max(0.0f, 1.0f - c2);
    auto comp = [&](float e, float kk) {
        float e2 = e * e, k2 = kk * kk;
        float t0 = e2 - k2 - s2;
        float a2b2 = std::sqrt(std::max(t0 * t0 + 4 * e2 * k2, 0.0f));
        float a = std::sqrt(std::max(0.5f * (a2b2 + t0), 0.0f));
        float rs = (a2b2 + c2 - 2 * ci * a) / (a2b2 + c2 + 2 * ci * a);
        float rp = (c2 * a2b2 + s2 * s2 - 2 * ci * a * s2) /
                   (c2 * a2b2 + s2 * s2 + 2 * ci * a * s2);
        return std::clamp(0.5f * (rs * rs + rp * rp), 0.0f, 1.0f);
    };
    return {comp(eta.x, k.x), comp(eta.y, k.y), comp(eta.z, k.z)};
}
float schlick_w(float c) {
    float m = std::clamp(1.0f - c, 0.0f, 1.0f);
    return m * m * m * m * m;
}
V3 schlick(V3 f0, float c) {
    float w = schlick_w(c);
    return f0 + (V3{1, 1, 1} - f0) * w;
}
float ggx_lambda(float a, float c) {
    float ac = std::fabs(c);
    if (ac <= 0) return 0;
    float s = std::sqrt(std::max(0.0f, 1.0f - ac * ac));
    if (s == 0) return 0;
    float t = s / ac, aa = a * t;
    return (-1.0f + std::sqrt(1.0f + aa * aa)) * 0.5f;
}
float ggx_g1(float a, float c) { return 1.0f / (1.0f + ggx_lambda(a, c)); }
// GGX D of half vector h about n, with 1 - cos^2 taken as |n x h|^2: near
// the normal 1 - cos^2 keeps no significant float digits, the cross
// product keeps full relative precision (ops/bsdf.py ggx_d).
float ggx_d(float a, V3 n, V3 h, bool clamp_negative = false) {
    float c = dot(n, h);
    V3 nxh = cross(n, h);
    float s2 = dot(nxh, nxh);
    if (clamp_negative && c < 0.0f) {
        s2 = 1.0f;
        c = 0.0f;
    }
    float a2 = a * a;
    float den = s2 + c * c * a2;
    return a2 / (kPi * den * den);
}
float ggx_pdf(float a, V3 n, V3 wo, V3 wi) {
    V3 wh = normalize(wo + wi);
    float ch = dot(n, wh), dwh = dot(wo, wh), co = dot(n, wo);
    if (co <= 0 || ch <= 0 || dwh <= 0) return 0;
    return ggx_d(a, n, wh) * ggx_g1(a, co) * ch / (4.0f * std::max(dwh, 1e-6f));
}
V3 to_local(V3 v, V3 n) {
    V3 t, b;
    build_onb(n, t, b);
    return {dot(v, t), dot(v, b), dot(v, n)};
}
V3 sample_vndf(V3 n, V3 wo, float rough, uint32_t& s) {
    V3 wol = to_local(normalize(wo), n);
    wol.z = std::max(wol.z, 1e-6f);
    float a = std::max(rough * rough, 1e-4f);
    V3 vh = normalize({a * wol.x, a * wol.y, wol.z});
    float lensq = vh.x * vh.x + vh.y * vh.y;
    V3 t1 = lensq > 0 ? V3{-vh.y, vh.x, 0} * (1.0f / std::sqrt(lensq))
                      : V3{1, 0, 0};
    V3 t2 = cross(vh, t1);
    float u1 = rand_uniform(s), u2 = rand_uniform(s);
    float r = std::sqrt(u1), phi = 2.0f * kPi * u2;
    float p1 = r * std::cos(phi), p2 = r * std::sin(phi);
    float sfac = 0.5f * (1.0f + vh.z);
    float p2a = (1.0f - sfac) * std::sqrt(std::max(0.0f, 1.0f - p1 * p1)) + sfac * p2;
    float p3 = std::sqrt(std::max(0.0f, 1.0f - p1 * p1 - p2a * p2a));
    V3 nh = p1 * t1 + p2a * t2 + p3 * vh;
    V3 ne = normalize({a * nh.x, a * nh.y, std::max(nh.z, 0.0f)});
    return normalize(to_world(ne, n));
}
void dfg_approx(float rough, float nov, float& x, float& y) {
    const float c0[4] = {-1.0f, -0.0275f, -0.572f, 0.022f};
    const float c1[4] = {1.0f, 0.0425f, 1.04f, -0.04f};
    float r[4];
    for (int i = 0; i < 4; ++i) r[i] = rough * c0[i] + c1[i];
    float a004 = std::min(r[0] * r[0], std::exp2(-9.28f * nov)) * r[0] + r[1];
    x = -1.04f * a004 + r[2];
    y = 1.04f * a004 + r[3];
}
V3 energy_comp(V3 f0, float rough, float nov) {
    float x, y;
    dfg_approx(rough, std::clamp(nov, 0.0f, 1.0f), x, y);
    auto comp = [&](float f) {
        float fss = std::clamp(f * x + y, 0.0f, 0.99f);
        float favg = f + (1.0f - f) / 21.0f;
        float om = std::clamp(1.0f - fss, 0.0f, 1.0f);
        float fms = (favg * om) / std::max(1.0f - favg * om, 1e-3f);
        return std::clamp((fss + fms) / std::max(fss, 1e-4f), 1.0f, 2.0f);
    };
    return {comp(f0.x), comp(f0.y), comp(f0.z)};
}

struct SampleResult {
    V3 dir, weight;
    float pdf = 0, dpdf = 0;
    bool delta = false;
    int medium_event = 0;
    // BSSRDF exit (ops/sss.py; the integrator restarts the ray here)
    bool has_exit = false;
    V3 exit_point{}, exit_normal{};
};
struct EvalResult {
    V3 value{};
    float pdf = 0;
    bool delta = false;
};

bool has_conductor(const Material& m) {
    return m.has_conductor > 0 || maxc(m.conductor_eta) > 0 || maxc(m.conductor_k) > 0;
}
V3 conductor_f0(const Material& m) {
    if (has_conductor(m)) return fresnel_conductor(1.0f, m.conductor_eta, m.conductor_k);
    return {std::clamp(m.base_color.x, 0.f, 1.f), std::clamp(m.base_color.y, 0.f, 1.f),
            std::clamp(m.base_color.z, 0.f, 1.f)};
}
bool material_is_delta(const Material& m) {
    if (m.type == 2) return true;
    if (m.type == 1 || m.type == 7)
        return std::clamp(m.roughness, 0.f, 1.f) <= 1e-3f;
    return false;
}

float plastic_coat_f0(const Material& m) {
    float eta = std::max(m.eta, 1.0f);
    float r = (eta - 1.0f) / std::max(eta + 1.0f, 1e-6f);
    return std::clamp(r * r, 0.0f, 0.999f);
}
V3 plastic_spec_tint(const Material& m) {
    V3 tint = m.coat_tint;
    if (m.coat_thickness <= 0 || maxc(m.coat_absorption) <= 1e-6f) return tint;
    return tint * vexp(m.coat_absorption * -m.coat_thickness);
}
V3 plastic_diffuse_trans(const Material& m, float ci, float co) {
    if (m.coat_thickness <= 0) return m.coat_tint;
    float si = std::max(ci, 1e-3f), so = std::max(co, 1e-3f);
    return m.coat_tint * vexp(m.coat_absorption * -(m.coat_thickness / si)) *
           vexp(m.coat_absorption * -(m.coat_thickness / so));
}

// ---- PBR metallic-roughness (mirrors ops/pbr.py; reference
// pathtrace.metal evaluate/sample_pbr_metallic_roughness:4632-4945) --------
struct PbrLobes {
    float roughness;
    V3 f0, diffuse_color;
    float transmission, reflect_scale;
    float p_spec, p_diff, p_trans;
    bool ok;
};

float pbr_dielectric_f0(float ior) {
    float eta = std::max(ior, 1.0f);
    float ratio = (eta - 1.0f) / std::max(eta + 1.0f, 1e-6f);
    return std::clamp(ratio * ratio, 0.0f, 0.99f);
}

PbrLobes pbr_lobes(const Material& m) {
    PbrLobes L;
    V3 base = {std::clamp(m.base_color.x, 0.f, 1.f),
               std::clamp(m.base_color.y, 0.f, 1.f),
               std::clamp(m.base_color.z, 0.f, 1.f)};
    float metallic = std::clamp(m.pbr_metallic, 0.f, 1.f);
    L.roughness = std::clamp(m.roughness, 0.f, 1.f);
    float fd = pbr_dielectric_f0(m.eta);
    L.f0 = {fd + (base.x - fd) * metallic, fd + (base.y - fd) * metallic,
            fd + (base.z - fd) * metallic};
    L.diffuse_color = base * (1.0f - metallic)
        * std::clamp(m.occlusion, 0.0f, 1.0f);
    L.transmission = std::clamp(m.pbr_transmission, 0.f, 1.f) * (1.0f - metallic);
    L.reflect_scale = 1.0f - L.transmission;
    float swb = std::clamp(maxc(L.f0), 0.05f, 0.95f);
    float w_spec = swb * L.reflect_scale;
    float w_diff = (1.0f - swb) * L.reflect_scale;
    float w_trans = L.transmission;
    float sum = w_spec + w_diff + w_trans;
    float safe = std::max(sum, 1e-20f);
    L.p_spec = w_spec / safe;
    L.p_diff = w_diff / safe;
    L.p_trans = w_trans / safe;
    L.ok = sum > 0.0f;
    return L;
}

V3 pbr_transmission_tint(const Material& m, float cos_theta) {
    float thickness = std::max(m.pbr_thickness, 0.0f);
    V3 sig = vmin0(m.sigma_a);
    if (thickness <= 0.0f || maxc(sig) <= 0.0f) return {1, 1, 1};
    float distance = thickness / std::max(std::fabs(cos_theta), 1e-3f);
    V3 tint = vexp(sig * -distance);
    return {std::clamp(tint.x, 0.f, 1.f), std::clamp(tint.y, 0.f, 1.f),
            std::clamp(tint.z, 0.f, 1.f)};
}

float ggx_vndf_pdf(float a, V3 n, V3 wo, V3 wh) {
    float co = dot(n, wo), ch = dot(n, wh);
    if (co <= 0.0f || ch <= 0.0f) return 0.0f;
    return ggx_d(a, n, wh) * ggx_g1(a, co) * ch / std::max(dot(wo, wh), 1e-6f);
}

EvalResult eval_pbr(const Material& m, V3 n, V3 wo, V3 wi) {
    EvalResult r;
    PbrLobes L = pbr_lobes(m);
    if (L.roughness <= 1e-3f) {
        r.delta = true;
        return r;
    }
    float cos_o = dot(n, wo), cos_i = dot(n, wi);
    float abs_o = std::fabs(cos_o), abs_i = std::fabs(cos_i);
    if (abs_o <= 0.0f || abs_i <= 0.0f || !L.ok) return r;
    float alpha = std::max(L.roughness * L.roughness, 1e-4f);

    if (cos_o * cos_i > 0.0f && cos_o > 0.0f && cos_i > 0.0f) {
        // reflection side (ops/pbr.py evaluate_pbr reflection block)
        V3 wh = normalize(wo + wi);
        if (dot(wh, n) > 0.0f && dot(wo, wh) > 0.0f && dot(wi, wh) > 0.0f) {
            float D = ggx_d(alpha, n, wh);
            float G = ggx_g1(alpha, cos_o) * ggx_g1(alpha, cos_i);
            V3 F = schlick(L.f0, dot(wi, wh));
            V3 spec = F * (D * G / std::max(4.0f * cos_o * cos_i, 1e-6f));
            spec = spec * energy_comp(L.f0, L.roughness, abs_o);
            spec = spec * L.reflect_scale;
            float pdf_spec = ggx_pdf(alpha, n, wo, wi);
            V3 diffuse = (L.diffuse_color / kPi) * L.reflect_scale;
            float pdf_diffuse = std::max(cos_i, 0.0f) / kPi;
            float pdf = L.p_spec * pdf_spec + L.p_diff * pdf_diffuse;
            if (pdf > 0.0f) {
                r.value = vmin0(spec + diffuse);
                r.pdf = pdf;
            }
        }
        return r;
    }

    // transmission side (opposite hemispheres)
    if (L.transmission <= 0.0f) return r;
    float eta_t0 = std::max(m.eta, 1.0f);
    bool inside = cos_o < 0.0f;
    float eta_i = inside ? eta_t0 : 1.0f;
    float eta_t = inside ? 1.0f : eta_t0;
    float eta = eta_i / eta_t;
    V3 wht = wo + wi * eta;
    if (dot(wht, wht) <= 0.0f) return r;
    wht = normalize(wht);
    if (dot(wht, n) <= 0.0f) wht = wht * -1.0f;
    float cos_o_wh = dot(wo, wht), cos_i_wh = dot(wi, wht);
    if (cos_o_wh * cos_i_wh > 0.0f) return r;
    float Dt = ggx_d(alpha, n, wht, true);
    float Gt = ggx_g1(alpha, abs_o) * ggx_g1(alpha, abs_i);
    float cost_unused;
    float Fr = fresnel_dielectric(cos_o_wh, eta_i, eta_t, cost_unused);
    float denom = cos_o_wh + eta * cos_i_wh;
    float denom_sq = denom * denom;
    if (std::fabs(denom_sq) <= 1e-8f) return r;
    float factor = (eta * eta) * std::fabs(cos_i_wh) * std::fabs(cos_o_wh);
    factor = factor / std::max(abs_o * abs_i * denom_sq, 1e-6f);
    V3 ft = pbr_transmission_tint(m, abs_i) * ((1.0f - Fr) * Dt * Gt * factor);
    ft = ft * L.transmission;
    float pdf_wh = ggx_vndf_pdf(alpha, n, wo, wht);
    float dwh_dwi = std::fabs((eta * eta * cos_i_wh) / std::max(denom_sq, 1e-8f));
    float pdf_trans = L.p_trans * pdf_wh * dwh_dwi;
    if (pdf_trans > 0.0f && finite3(ft)) {
        r.value = vmin0(ft);
        r.pdf = pdf_trans;
    }
    return r;
}

SampleResult sample_pbr(const Material& m, V3 n, V3 wo, V3 incident,
                        uint32_t& s) {
    // RNG order mirrors ops/pbr.py sample_pbr exactly: 1 selector draw,
    // then the chosen lobe draws 2 (VNDF / cosine) unless delta (0).
    SampleResult r;
    PbrLobes L = pbr_lobes(m);
    bool smooth = L.roughness <= 1e-3f;
    float alpha = std::max(L.roughness * L.roughness, 1e-4f);
    float choose = rand_uniform(s);
    bool lobe_spec = choose < L.p_spec;
    bool lobe_diff = !lobe_spec && choose < L.p_spec + L.p_diff;

    float cos_o = dot(n, wo);
    float abs_o = std::fabs(cos_o);
    V3 wi{}, f{};
    float lobe_pdf = 0.0f;
    bool branch_ok = false, delta = false;

    if (lobe_spec) {
        if (smooth) {
            wi = reflect(incident, n);
            f = schlick(L.f0, std::max(cos_o, 0.0f)) * L.reflect_scale;
            lobe_pdf = 1.0f;
            branch_ok = dot(n, wi) > 0.0f;
            delta = true;
        } else {
            V3 wh = sample_vndf(n, wo, L.roughness, s);
            wi = normalize(reflect(wo * -1.0f, wh));
            float cos_i = dot(n, wi);
            float D = ggx_d(alpha, n, wh);
            float G = ggx_g1(alpha, std::max(cos_o, 0.0f)) * ggx_g1(alpha, cos_i);
            f = schlick(L.f0, dot(wi, wh)) *
                (D * G / std::max(4.0f * std::max(cos_o, 0.0f) * cos_i, 1e-6f));
            f = f * energy_comp(L.f0, L.roughness, std::max(cos_o, 0.0f));
            f = f * L.reflect_scale;
            lobe_pdf = ggx_pdf(alpha, n, wo, wi);
            branch_ok = cos_i > 0.0f;
        }
        r.pdf = L.p_spec * lobe_pdf;
    } else if (lobe_diff) {
        V3 local = cosine_hemisphere(s);
        wi = normalize(to_world(local, n));
        float cos_i = dot(n, wi);
        f = (L.diffuse_color / kPi) * L.reflect_scale;
        lobe_pdf = std::max(cos_i, 0.0f) / kPi;
        branch_ok = cos_i > 0.0f;
        r.pdf = L.p_diff * lobe_pdf;
    } else {
        float eta_t0 = std::max(m.eta, 1.0f);
        bool inside = cos_o < 0.0f;
        float eta_i = inside ? eta_t0 : 1.0f;
        float eta_t = inside ? 1.0f : eta_t0;
        float eta = eta_i / eta_t;
        if (smooth) {
            V3 wt = refract(incident, n, eta);
            float len2 = dot(wt, wt);
            branch_ok = len2 > 0.0f;
            if (branch_ok) {
                wi = wt * (1.0f / std::sqrt(std::max(len2, 1e-38f)));
                float cost = 0.0f;
                float Fr = fresnel_dielectric(cos_o, eta_i, eta_t, cost);
                float eta_scale = (eta_t * eta_t) / (eta_i * eta_i);
                float dir_scale =
                    eta_scale * (std::fabs(cost) / std::max(abs_o, 1e-6f));
                f = pbr_transmission_tint(m, std::fabs(dot(n, wi))) *
                    (std::max(1.0f - Fr, 0.0f) * dir_scale) * L.transmission;
            }
            lobe_pdf = 1.0f;
            delta = true;
        } else {
            V3 wh = sample_vndf(n, wo, L.roughness, s);
            V3 wt = refract(wo * -1.0f, wh, eta);
            float len2 = dot(wt, wt);
            if (len2 > 0.0f) {
                wi = wt * (1.0f / std::sqrt(std::max(len2, 1e-38f)));
                float cos_i = dot(n, wi);
                float abs_i = std::fabs(cos_i);
                float cos_o_wh = dot(wo, wh), cos_i_wh = dot(wi, wh);
                float Dt = ggx_d(alpha, n, wh, true);
                float Gt = ggx_g1(alpha, abs_o) * ggx_g1(alpha, abs_i);
                float cost_unused;
                float Fr = fresnel_dielectric(cos_o_wh, eta_i, eta_t, cost_unused);
                float denom = cos_o_wh + eta * cos_i_wh;
                float denom_sq = denom * denom;
                float factor = (eta * eta) * std::fabs(cos_i_wh) *
                               std::fabs(cos_o_wh);
                factor = factor / std::max(abs_o * abs_i * denom_sq, 1e-6f);
                f = pbr_transmission_tint(m, abs_i) *
                    ((1.0f - Fr) * Dt * Gt * factor) * L.transmission;
                float pdf_wh = ggx_vndf_pdf(alpha, n, wo, wh);
                float dwh_dwi =
                    std::fabs((eta * eta * cos_i_wh) / std::max(denom_sq, 1e-8f));
                lobe_pdf = pdf_wh * dwh_dwi;
                branch_ok = (cos_i * cos_o < 0.0f) && (cos_o_wh * cos_i_wh <= 0.0f) &&
                            (std::fabs(denom_sq) > 1e-8f);
            }
        }
        r.pdf = L.p_trans * lobe_pdf;
    }

    float cos_i = dot(n, wi);
    float abs_i = std::fabs(cos_i);
    V3 weight = vmin0(f * (abs_i / std::max(r.pdf, 1e-20f)));
    if (!L.ok || !branch_ok || abs_i <= 0.0f || r.pdf <= 0.0f ||
        !finite3(weight)) {
        r.pdf = 0.0f;
        return r;
    }
    r.dir = wi;
    r.weight = weight;
    r.dpdf = r.pdf;
    r.delta = delta;
    return r;
}

// ---- CarPaint: base (diffuse/conductor) + procedural flakes + clearcoat
// (mirrors ops/carpaint.py; reference pathtrace.metal carpaint_*:3300-3536,
// sample case 6:5508-5633, evaluate case 6:5079-5110) ----------------------
float plastic_coat_roughness_cp(const Material& m) {
    return std::max(std::clamp(m.coat_roughness, 0.f, 1.f), 1e-3f);
}

V3 carpaint_flake_normal(const Material& m, V3 position, V3 normal) {
    // floor-mod matches jnp.mod(x, 1.0) for negative inputs too
    auto fm = [](float x) { return x - std::floor(x); };
    V3 p = position * m.cp_flake_scale;
    V3 q = {fm(p.x * 0.3183099f + 0.1f), fm(p.y * 0.3183099f + 0.3f),
            fm(p.z * 0.3183099f + 0.7f)};
    float s = q.x * (q.y + 33.33f) + q.y * (q.z + 55.55f) + q.z * (q.x + 77.77f);
    q = q + V3{s, s, s};
    V3 rand = {fm((q.x + q.y) * 13.5453123f), fm((q.x + q.z) * 13.5453123f),
               fm((q.y + q.z) * 13.5453123f)};
    float anis = m.cp_flake_anisotropy;
    float ax = std::max(1.0f - anis, 1e-3f), ay = std::max(1.0f + anis, 1e-3f);
    float phi = 2.0f * kPi * rand.x;
    float r = std::sqrt(std::max(rand.y, 1e-4f));
    float x = r * std::cos(phi) * ax, y = r * std::sin(phi) * ay;
    float m2 = std::clamp(x * x + y * y, 0.0f, 0.99f);
    float z = std::sqrt(std::max(1.0f - m2, 0.0f));
    V3 t, b;
    build_onb(normal, t, b);
    V3 pert = normalize(x * t + y * b + z * normal);
    float st = m.cp_flake_normal_strength;
    return normalize(normal + (pert - normal) * st);
}

V3 carpaint_base_f0(const Material& m) {
    if (m.cp_has_base_conductor > 0.0f)
        return fresnel_conductor(1.0f, m.cp_base_eta, m.cp_base_k);
    return {std::clamp(m.base_color.x, 0.f, 1.f),
            std::clamp(m.base_color.y, 0.f, 1.f),
            std::clamp(m.base_color.z, 0.f, 1.f)};
}

void carpaint_eval_coat(const Material& m, V3 n, V3 wo, V3 wi, V3& f, float& pdf) {
    f = {0, 0, 0};
    pdf = 0;
    float co = std::max(dot(n, wo), 0.0f), ci = std::max(dot(n, wi), 0.0f);
    if (ci <= 0 || co <= 0) return;
    float rough = plastic_coat_roughness_cp(m);
    float alpha = std::max(rough * rough, 1e-4f);
    V3 wh = normalize(wo + wi);
    if (!(dot(wh, n) > 0 && dot(wo, wh) > 0 && dot(wi, wh) > 0)) return;
    float D = ggx_d(alpha, n, wh);
    float G = ggx_g1(alpha, co) * ggx_g1(alpha, ci);
    float f0 = plastic_coat_f0(m);
    V3 F = schlick({f0, f0, f0}, dot(wi, wh));
    V3 spec = F * (D * G / std::max(4.0f * co * ci, 1e-6f));
    spec = spec * plastic_spec_tint(m);
    float pdf_raw = ggx_pdf(alpha, n, wo, wi);
    if (pdf_raw <= 0) return;
    f = spec;
    pdf = pdf_raw;
}

void carpaint_eval_flake(const Material& m, V3 position, V3 n, V3 wo, V3 wi,
                         V3& f, float& pdf) {
    f = {0, 0, 0};
    pdf = 0;
    V3 fn = carpaint_flake_normal(m, position, n);
    float co = std::max(dot(fn, wo), 0.0f), ci = std::max(dot(fn, wi), 0.0f);
    if (ci <= 0 || co <= 0) return;
    float rough = std::max(std::clamp(m.cp_flake_roughness, 0.f, 1.f), 1e-3f);
    float alpha = rough * rough;
    V3 wh = normalize(wo + wi);
    if (!(dot(wh, fn) > 0 && dot(wo, wh) > 0 && dot(wi, wh) > 0)) return;
    float D = ggx_d(alpha, fn, wh);
    float G = ggx_g1(alpha, co) * ggx_g1(alpha, ci);
    V3 F = schlick(carpaint_base_f0(m), dot(wi, wh));
    V3 spec = F * (D * G / std::max(4.0f * co * ci, 1e-6f));
    spec = spec * plastic_spec_tint(m);
    float coat_avg = std::clamp(m.coat_fresnel_avg, 0.0f, 1.0f);
    spec = spec * std::max(1.0f - coat_avg, 0.0f);
    float pdf_raw = ggx_pdf(alpha, fn, wo, wi);
    if (pdf_raw <= 0) return;
    f = spec;
    pdf = pdf_raw;
}

void carpaint_eval_base(const Material& m, V3 n, V3 wo, V3 wi, V3& f, float& pdf) {
    f = {0, 0, 0};
    pdf = 0;
    float co = std::max(dot(n, wo), 0.0f), ci = std::max(dot(n, wi), 0.0f);
    if (ci <= 0 || co <= 0) return;
    float metallic = std::clamp(m.cp_base_metallic, 0.f, 1.f);
    float diffuse_w = std::max(1.0f - metallic, 0.0f);
    float spec_w = std::max(metallic, 0.0f);
    if (diffuse_w <= 1e-4f && spec_w <= 1e-4f) return;
    float coat_avg = std::clamp(m.coat_fresnel_avg, 0.0f, 1.0f);
    V3 base = {std::clamp(m.base_color.x, 0.f, 1.f),
               std::clamp(m.base_color.y, 0.f, 1.f),
               std::clamp(m.base_color.z, 0.f, 1.f)};

    V3 combined{};
    float pdf_diffuse = 0;
    if (diffuse_w > 1e-4f) {
        V3 diffuse = base / kPi;
        diffuse = diffuse * plastic_diffuse_trans(m, ci, co);
        diffuse = vmin0(diffuse * std::max(1.0f - coat_avg, 0.0f));
        combined = combined + diffuse * diffuse_w;
        pdf_diffuse = ci / kPi;
    }

    float rough = std::max(std::clamp(m.cp_base_roughness, 0.f, 1.f), 1e-3f);
    float alpha = rough * rough;
    V3 wh = normalize(wo + wi);
    float pdf_spec = 0;
    bool half_ok = dot(wh, n) > 0 && dot(wo, wh) > 0 && dot(wi, wh) > 0;
    if (spec_w > 1e-4f && half_ok) {
        float D = ggx_d(alpha, n, wh);
        float G = ggx_g1(alpha, co) * ggx_g1(alpha, ci);
        V3 F = m.cp_has_base_conductor > 0.0f
                   ? fresnel_conductor(dot(wi, wh), m.cp_base_eta, m.cp_base_k)
                   : schlick(base, dot(wi, wh));
        V3 spec = F * (D * G / std::max(4.0f * co * ci, 1e-6f));
        spec = vmin0(spec * plastic_spec_tint(m) * std::max(1.0f - coat_avg, 0.0f));
        combined = combined + spec * spec_w;
        float pdf_raw = ggx_pdf(alpha, n, wo, wi);
        if (pdf_raw > 0) pdf_spec = pdf_raw;
    }
    f = vmin0(combined);
    pdf = diffuse_w * pdf_diffuse + spec_w * pdf_spec;
}

void carpaint_lobe_probs(const Material& m, float& p_coat, float& p_flake,
                         float& p_base) {
    p_coat = std::clamp(m.coat_sample_weight, 0.0f, 0.95f);
    p_flake = std::clamp(m.cp_flake_sample_weight, 0.0f, 0.95f);
    p_base = std::max(1.0f - (p_coat + p_flake), 0.0f);
    float norm = p_coat + p_flake + p_base;
    if (norm <= 1e-6f) {
        p_coat = p_flake = 0.0f;
        p_base = 1.0f;
        norm = 1.0f;
    }
    p_coat /= norm;
    p_flake /= norm;
    p_base /= norm;
}

EvalResult eval_carpaint(const Material& m, V3 position, V3 n, V3 wo, V3 wi) {
    EvalResult r;
    float p_coat, p_flake, p_base;
    carpaint_lobe_probs(m, p_coat, p_flake, p_base);
    V3 cf, ff, bf;
    float cp, fp, bp;
    carpaint_eval_coat(m, n, wo, wi, cf, cp);
    carpaint_eval_flake(m, position, n, wo, wi, ff, fp);
    carpaint_eval_base(m, n, wo, wi, bf, bp);
    r.value = bf * p_base + ff * p_flake + cf * p_coat;
    r.pdf = p_base * bp + p_flake * fp + p_coat * cp;
    if (r.pdf <= 0 || !finite3(r.value)) {
        r.value = {0, 0, 0};
        r.pdf = 0;
    }
    return r;
}

SampleResult sample_carpaint(const Material& m, V3 position, V3 n, V3 wo,
                             uint32_t& s) {
    // RNG order mirrors ops/carpaint.py sample_carpaint: 1 selector draw;
    // coat/flake draw 2 (VNDF); base draws 1 (sub-lobe) + 2 (VNDF/cosine).
    SampleResult out;
    float p_coat, p_flake, p_base;
    carpaint_lobe_probs(m, p_coat, p_flake, p_base);
    float r = rand_uniform(s);
    int lobe = 0;  // 0 base, 1 flake, 2 coat
    if (p_coat > 0.0f && r < p_coat)
        lobe = 2;
    else if (p_flake > 0.0f && r < p_coat + p_flake)
        lobe = 1;
    if (lobe == 0 && p_base <= 1e-6f) {
        if (p_flake > p_coat && p_flake > 0.0f)
            lobe = 1;
        else if (p_coat > 0.0f)
            lobe = 2;
    }

    V3 fn = carpaint_flake_normal(m, position, n);
    V3 wi{};
    bool branch_ok = false;
    if (lobe == 2) {
        V3 wh = sample_vndf(n, wo, plastic_coat_roughness_cp(m), s);
        wi = normalize(reflect(wo * -1.0f, wh));
        branch_ok = dot(wh, n) > 0.0f;
    } else if (lobe == 1) {
        float rough = std::max(std::clamp(m.cp_flake_roughness, 0.f, 1.f), 1e-3f);
        V3 wh = sample_vndf(fn, wo, rough, s);
        wi = normalize(reflect(wo * -1.0f, wh));
        branch_ok = dot(wh, fn) > 0.0f;
    } else {
        float metallic = std::clamp(m.cp_base_metallic, 0.f, 1.f);
        float diffuse_w = std::max(1.0f - metallic, 0.0f);
        float spec_w = std::max(metallic, 0.0f);
        float choose = rand_uniform(s);
        bool sample_spec = spec_w > 0.0f && (diffuse_w + spec_w) > 0.0f &&
                           choose < spec_w / std::max(diffuse_w + spec_w, 1e-6f);
        if (sample_spec) {
            float rough = std::max(std::clamp(m.cp_base_roughness, 0.f, 1.f), 1e-3f);
            V3 wh = sample_vndf(n, wo, rough, s);
            wi = normalize(reflect(wo * -1.0f, wh));
            branch_ok = dot(wh, n) > 0.0f;
        } else {
            V3 local = cosine_hemisphere(s);
            wi = normalize(to_world(local, n));
            branch_ok = true;
        }
    }

    bool dir_ok = branch_ok && finite3(wi) && dot(n, wi) > 0.0f;
    V3 cf, ff, bf;
    float cp, fp, bp;
    carpaint_eval_coat(m, n, wo, wi, cf, cp);
    carpaint_eval_flake(m, position, n, wo, wi, ff, fp);
    carpaint_eval_base(m, n, wo, wi, bf, bp);
    float combined_pdf = p_base * bp + p_flake * fp + p_coat * cp;
    V3 sel_f = lobe == 2 ? cf : (lobe == 1 ? ff : bf);
    float sel_pdf = lobe == 2 ? cp : (lobe == 1 ? fp : bp);
    float ci = std::max(dot(n, wi), 0.0f);
    V3 weight = sel_f * (ci / std::max(combined_pdf, 1e-20f));
    bool ok = dir_ok && combined_pdf > 0.0f && sel_pdf > 0.0f &&
              maxc(sel_f) > 0.0f && ci > 0.0f && finite3(weight);
    if (!ok) return out;
    out.dir = wi;
    out.weight = vmin0(weight);
    out.pdf = combined_pdf;
    out.dpdf = std::max(sel_pdf, 0.0f);
    return out;
}

// ---- Subsurface scattering (mirrors ops/sss.py; reference
// pathtrace.metal sss_*:3912-4059, case 5:5420-5508, random walk
// sample_sss_random_walk_software:4060-4310) -------------------------------
constexpr float kSssCutoff = 1e-3f;

inline V3 vmaxf(V3 v, float lo) {
    return {std::max(v.x, lo), std::max(v.y, lo), std::max(v.z, lo)};
}
inline V3 vclamp01(V3 v, float hi = 1.0f) {
    return {std::clamp(v.x, 0.0f, hi), std::clamp(v.y, 0.0f, hi),
            std::clamp(v.z, 0.0f, hi)};
}
float schlick_scalar(float f0, float c) { return f0 + (1.0f - f0) * schlick_w(c); }

V3 sss_sigma_a_m(const Material& m, V3 base, float mfp, float anis) {
    float sigma_t = 1.0f / std::max(mfp, 1e-4f);
    V3 ss = vclamp01(base, 0.999f) * sigma_t;
    ss = vmin0(ss) * std::max(1.0f - anis, 0.01f);
    if (m.ss_override > 0.5f) return vmaxf(m.ss_a, 1e-6f);
    return vmaxf(V3{sigma_t, sigma_t, sigma_t} - ss, 1e-6f);
}
V3 sss_sigma_s_prime_m(const Material& m, V3 base, float mfp, float anis) {
    float sigma_t = 1.0f / std::max(mfp, 1e-4f);
    V3 derived = vmin0(vclamp01(base, 0.999f) * sigma_t);
    V3 out = m.ss_override > 0.5f ? vmin0(m.ss_s) : derived;
    return out * std::max(1.0f - anis, 0.01f);
}
V3 sss_diffusion_profile(float radius, V3 sa, V3 ssp) {
    auto chan = [&](float a, float sp) {
        float stp = std::max(a + sp, 1e-6f);
        float alpha_p = std::clamp(sp / stp, 0.0f, 1.0f);
        float d = 1.0f / std::max(3.0f * stp, 1e-6f);
        float str = std::sqrt(std::max(a / d, 1e-6f));
        float r = std::max(radius, 1e-4f);
        float zr = 1.0f / stp;
        float dr = std::sqrt(r * r + zr * zr);
        float vr = zr + 4.0f * d;
        float dv = std::sqrt(r * r + vr * vr);
        float term_dr = (zr * (1.0f + str * dr)) / std::max(dr * dr * dr, 1e-6f);
        float term_dv = (vr * (1.0f + str * dv)) / std::max(dv * dv * dv, 1e-6f);
        float p = (alpha_p / (4.0f * kPi)) *
                  (term_dr * std::exp(-str * dr) + term_dv * std::exp(-str * dv));
        return std::max(p, 0.0f);
    };
    return {chan(sa.x, ssp.x), chan(sa.y, ssp.y), chan(sa.z, ssp.z)};
}
float sss_sigma_tr_scalar_m(V3 sa, V3 ssp) {
    auto chan = [](float a, float sp) {
        float stp = std::max(a + sp, 1e-6f);
        float d = 1.0f / std::max(3.0f * stp, 1e-6f);
        return std::sqrt(std::max(a / d, 1e-6f));
    };
    V3 str = {chan(sa.x, ssp.x), chan(sa.y, ssp.y), chan(sa.z, ssp.z)};
    float lum = str.x * 0.2126f + str.y * 0.7152f + str.z * 0.0722f;
    return std::max(lum, 1e-4f);
}
V3 sample_hg_world(V3 reference_dir, float g, uint32_t& s) {
    float u1 = rand_uniform(s), u2 = rand_uniform(s);
    bool iso = std::fabs(g) < 1e-3f;
    float sq = (1.0f - g * g) / (1.0f - g + 2.0f * g * u1);
    float cos_aniso =
        std::clamp((1.0f + g * g - sq * sq) / (2.0f * (iso ? 1.0f : g)), -1.0f, 1.0f);
    float ct = iso ? 1.0f - 2.0f * u1 : cos_aniso;
    float st = std::sqrt(std::max(0.0f, 1.0f - ct * ct));
    float phi = 2.0f * kPi * u2;
    V3 local = {st * std::cos(phi), st * std::sin(phi), ct};
    V3 ref = normalize(reference_dir);
    V3 t, b;
    build_onb(ref, t, b);
    return normalize(local.x * t + local.y * b + local.z * ref);
}
V3 offset_surface_point(V3 point, V3 normal, V3 dir) {
    bool ok = finite3(normal) && dot(normal, normal) > 0.0f;
    V3 n = ok ? normalize(normal) : V3{0, 1, 0};
    float sign = dot(dir, n) >= 0.0f ? 1.0f : -1.0f;
    V3 o = point + n * (sign * kRayOriginEpsilon * 4.0f);
    return o + dir * (kRayOriginEpsilon * 0.5f);
}

SampleResult sample_lambert_fb(const Material& m, V3 n, uint32_t& s) {
    SampleResult r;
    V3 local = cosine_hemisphere(s);
    V3 wi = normalize(to_world(local, n));
    float ci = dot(n, wi);
    if (ci <= 0) return r;
    float pdf = ci / kPi;
    V3 base = vclamp01(m.base_color);
    V3 weight = vmin0((base / kPi) * (ci / std::max(pdf, 1e-20f)));
    if (pdf <= 0 || !finite3(weight)) return r;
    r.dir = wi;
    r.weight = weight;
    r.pdf = r.dpdf = pdf;
    return r;
}

SampleResult sample_subsurface_oracle(const Material& m, V3 pos, V3 n, V3 wo,
                                      int sss_mode, uint32_t& s) {
    // sample_bsdf case 5 (ops/sss.py sample_subsurface): separable BSSRDF
    // when sss_mode==1 and the material is separable, else lambert fallback.
    if (sss_mode != 1) return sample_lambert_fb(m, n, s);
    float mfp = std::max(m.ss_mfp, 1e-4f);
    float anis = std::clamp(m.ss_g, -0.99f, 0.99f);
    V3 base = vclamp01(m.base_color);
    V3 sa = sss_sigma_a_m(m, base, mfp, anis);
    V3 ssp = sss_sigma_s_prime_m(m, base, mfp, anis);
    float sigma_tr = sss_sigma_tr_scalar_m(sa, ssp);
    bool separable = m.ss_method < 0.5f && mfp > 1e-4f && sigma_tr > 0.0f;
    if (!separable) return sample_lambert_fb(m, n, s);

    SampleResult r;
    // 4 draws: radius, phi, cosine x2
    float u_r = std::clamp(rand_uniform(s), 1e-6f, 1.0f - 1e-6f);
    float radius = -std::log(1.0f - u_r) / std::max(sigma_tr, 1e-4f);
    radius = std::min(radius, mfp * 10.0f);
    float pdf_radius =
        std::max(sigma_tr, 1e-4f) * std::exp(-std::max(sigma_tr, 1e-4f) * radius);
    float phi = 2.0f * kPi * rand_uniform(s);
    V3 t, b;
    build_onb(n, t, b);
    V3 exit_point = pos + t * (radius * std::cos(phi)) + b * (radius * std::sin(phi));
    V3 local = cosine_hemisphere(s);
    V3 wi = normalize(to_world(local, n));
    float cos_exit = dot(n, wi);
    float pdf_dir = std::max(cos_exit, 0.0f) / kPi;
    float pdf_area = pdf_radius / (2.0f * kPi * std::max(radius, 1e-4f));

    V3 profile = sss_diffusion_profile(radius, sa, ssp);
    V3 coat_tint = vclamp01(m.coat_tint);
    float coat_average = 1.0f - std::clamp(m.coat_fresnel_avg, 0.0f, 1.0f);
    float cior = std::max(m.coat_ior, 1.0f);
    float f0 = ((cior - 1.0f) / (cior + 1.0f)) * ((cior - 1.0f) / (cior + 1.0f));
    float cos_in = std::max(dot(n, wo), 0.0f);
    float trans_in = 1.0f - schlick_scalar(f0, cos_in);
    float trans_out = 1.0f - schlick_scalar(f0, cos_exit);
    float coat_transmission = std::clamp(trans_in * trans_out, 0.0f, 1.0f);
    bool has_coat = m.ss_coat > 0.5f;
    if (has_coat) profile = profile * coat_tint;
    float coat_trans_eff = has_coat ? coat_transmission : 1.0f;

    V3 weight = profile * (cos_exit * coat_average * coat_trans_eff);
    float denom = std::max(pdf_area * pdf_dir, 1e-6f);
    weight = vmin0(weight * (1.0f / denom));
    bool ok = pdf_radius > 0.0f && std::isfinite(pdf_radius) && cos_exit > 0.0f &&
              pdf_dir > 0.0f && pdf_area > 0.0f && finite3(weight);
    if (!ok) return r;  // invalid sample; 4 draws stay consumed (JAX keeps st)
    r.dir = wi;
    r.weight = weight;
    r.pdf = denom;
    r.dpdf = pdf_dir;
    r.has_exit = true;
    r.exit_point = exit_point;
    r.exit_normal = n;
    return r;
}

SampleResult sample_sss_walk_oracle(const Scene& sc, const Material& m,
                                    const Hit& rec, V3 wo, V3 incident,
                                    int max_steps, uint32_t& s) {
    // ops/sss.py sample_sss_random_walk: 1 selector; coat lobe draws 2
    // (VNDF); walk draws 1 per step (+2 HG on scatter steps).
    SampleResult out;
    V3 n = rec.normal;
    float p_coat = std::clamp(m.coat_sample_weight, 0.0f, 1.0f);
    float rl = rand_uniform(s);
    bool take_coat = p_coat > 0.0f && rl < p_coat;

    if (take_coat) {
        float rough = plastic_coat_roughness_cp(m);
        float alpha = rough * rough;
        float f0 = plastic_coat_f0(m);
        V3 f0c = {f0, f0, f0};
        V3 wh = sample_vndf(n, wo, rough, s);
        V3 wi = normalize(reflect(wo * -1.0f, wh));
        float ci = dot(n, wi), co = dot(n, wo);
        float D = ggx_d(alpha, n, wh);
        float G = ggx_g1(alpha, co) * ggx_g1(alpha, ci);
        V3 F = schlick(f0c, dot(wi, wh));
        V3 spec = F * (D * G / std::max(4.0f * co * ci, 1e-6f));
        spec = spec * plastic_spec_tint(m);
        float spec_pdf = ggx_pdf(alpha, n, wo, wi);
        float combined = std::max(p_coat * spec_pdf, 1e-6f);
        V3 weight = vmin0(spec * (ci / combined));
        bool ok = dot(wh, n) > 0.0f && finite3(wi) && ci > 0.0f && co > 0.0f &&
                  dot(wi, wh) > 0.0f && spec_pdf > 0.0f && finite3(weight);
        if (!ok) return out;
        out.dir = wi;
        out.weight = weight;
        out.pdf = combined;
        out.dpdf = spec_pdf;
        return out;
    }

    float p_diffuse = std::max(1.0f - p_coat, 1e-3f);
    float anis = std::clamp(m.ss_g, -0.99f, 0.99f);
    float mfp = std::max(m.ss_mfp, 1e-4f);
    V3 base = vclamp01(m.base_color);
    V3 sa = sss_sigma_a_m(m, base, mfp, anis);
    V3 ssp = sss_sigma_s_prime_m(m, base, mfp, anis);
    V3 sigma_t = vmaxf(sa + ssp, 1e-6f);
    float sigma_t_scalar = std::max(maxc(sigma_t), 1e-4f);
    bool has_coat = m.ss_coat > 0.5f;

    V3 tp = V3{1, 1, 1} * (1.0f / p_diffuse);
    float eta_inside = std::max(m.eta, 1.0f);
    V3 unit_dir = incident;
    float cos_i = dot(unit_dir * -1.0f, n);
    float cos_t = 0.0f;
    float fr_entry = fresnel_dielectric(cos_i, 1.0f, eta_inside, cos_t);
    V3 enter_dir = refract(unit_dir, n, 1.0f / eta_inside);
    bool enter_ok = cos_i > 0.0f && finite3(enter_dir) && dot(enter_dir, enter_dir) > 0.0f;
    if (!enter_ok) return out;
    enter_dir = normalize(enter_dir);
    float eta_scale = eta_inside * eta_inside;
    float dir_scale = eta_scale * (cos_t / std::max(cos_i, 1e-6f));
    tp = tp * (std::max(1.0f - fr_entry, 0.0f) * dir_scale);
    if (has_coat) tp = tp * plastic_spec_tint(m);

    V3 pos = offset_surface_point(rec.point, n * -1.0f, enter_dir);
    V3 dir = enter_dir;

    for (int step = 0; step < std::max(max_steps, 1); ++step) {
        float xi = std::clamp(rand_uniform(s), 1e-6f, 1.0f - 1e-6f);
        float distance = -std::log(1.0f - xi) / sigma_t_scalar;
        Hit b;
        if (!trace(sc, pos, dir, kRayOriginEpsilon, kInfinity, -1, b)) break;
        float boundary_dist = std::max(b.t, 1e-4f);
        if (distance < boundary_dist) {
            // volume scatter
            tp = tp * vexp(sigma_t * -distance);
            V3 albedo = vclamp01(V3{ssp.x / std::max(sigma_t.x, 1e-6f),
                                    ssp.y / std::max(sigma_t.y, 1e-6f),
                                    ssp.z / std::max(sigma_t.z, 1e-6f)});
            tp = tp * albedo;
            if (maxc(tp) < kSssCutoff) break;
            V3 new_dir = sample_hg_world(dir * -1.0f, anis, s);
            if (!(finite3(new_dir) && dot(new_dir, new_dir) > 0.0f)) break;
            pos = pos + dir * distance;
            dir = new_dir;
            continue;
        }
        // boundary
        tp = tp * vexp(sigma_t * -boundary_dist);
        if (maxc(tp) < kSssCutoff) break;
        V3 outward = b.front ? b.normal : b.normal * -1.0f;
        if (!(finite3(outward) && dot(outward, outward) > 0.0f)) break;
        outward = normalize(outward);
        float cos_exit_i = dot(dir * -1.0f, outward);
        bool internal = cos_exit_i <= 0.0f;
        float cos_exit_t = 0.0f;
        float fr_exit = fresnel_dielectric(cos_exit_i, eta_inside, 1.0f, cos_exit_t);
        V3 refracted = refract(dir, outward, eta_inside);
        bool refract_fail =
            !(finite3(refracted) && dot(refracted, refracted) > 0.0f);
        if (internal || refract_fail) {
            // total internal reflection: bounce inside
            pos = b.point;
            dir = normalize(reflect(dir, outward));
            continue;
        }
        refracted = normalize(refracted);
        float dir_scale_exit =
            (1.0f / (eta_inside * eta_inside)) * (cos_exit_t / std::max(cos_exit_i, 1e-6f));
        V3 tp_exit = tp * (std::max(1.0f - fr_exit, 0.0f) * dir_scale_exit);
        if (has_coat) tp_exit = tp_exit * plastic_spec_tint(m);
        tp_exit = vmin0(tp_exit);
        if (!finite3(tp_exit)) break;
        out.dir = refracted;
        out.weight = tp_exit;
        out.pdf = std::max(p_diffuse, 1e-4f);
        out.dpdf = 1.0f;
        out.has_exit = true;
        out.exit_point = b.point;
        out.exit_normal = outward;
        return out;
    }
    return out;  // absorbed / step-capped: invalid sample
}

EvalResult eval_bsdf(const Material& m, V3 pos, V3 n, V3 wo, V3 wi) {
    EvalResult r;
    if (m.type == 7) return eval_pbr(m, n, wo, wi);
    if (m.type == 6) return eval_carpaint(m, pos, n, wo, wi);
    if (m.type == 5) return r;  // BSSRDF: NEE excluded (evaluate_bsdf is_bssrdf)
    float co = std::max(dot(n, wo), 0.0f), ci = std::max(dot(n, wi), 0.0f);
    if (ci <= 0 || co <= 0) return r;
    switch (m.type) {
        case 0: {
            r.value = m.base_color / kPi;
            r.pdf = ci / kPi;
            break;
        }
        case 1: {
            float rough = std::clamp(m.roughness, 0.f, 1.f);
            if (rough <= 1e-3f) {
                r.delta = true;
                break;
            }
            float a = rough * rough;
            V3 wh = normalize(wo + wi);
            if (dot(wh, n) <= 0 || dot(wo, wh) <= 0 || dot(wi, wh) <= 0) break;
            float D = ggx_d(a, n, wh);
            float G = ggx_g1(a, co) * ggx_g1(a, ci);
            V3 f0 = conductor_f0(m);
            V3 F = has_conductor(m)
                       ? fresnel_conductor(dot(wi, wh), m.conductor_eta, m.conductor_k)
                       : schlick(f0, dot(wi, wh));
            V3 spec = F * (D * G / std::max(4.0f * co * ci, 1e-6f));
            spec = spec * energy_comp(f0, rough, co);
            float pdf = ggx_pdf(a, n, wo, wi);
            if (pdf > 0) {
                r.value = vmin0(spec);
                r.pdf = pdf;
            }
            break;
        }
        case 2:
            r.delta = true;
            break;
        case 4: {
            float cr = std::max(std::clamp(m.coat_roughness, 0.f, 1.f), 1e-3f);
            float a = cr * cr;
            float f0 = plastic_coat_f0(m);
            V3 f0c = {f0, f0, f0};
            V3 spec{};
            float pdf_s = 0;
            V3 wh = normalize(wo + wi);
            if (dot(wh, n) > 0 && dot(wo, wh) > 0 && dot(wi, wh) > 0) {
                float D = ggx_d(a, n, wh);
                float G = ggx_g1(a, co) * ggx_g1(a, ci);
                V3 F = schlick(f0c, dot(wi, wh));
                spec = F * (D * G / std::max(4.0f * co * ci, 1e-6f));
                spec = vmin0(spec * plastic_spec_tint(m));
                pdf_s = ggx_pdf(a, n, wo, wi);
            }
            V3 Fi = schlick(f0c, ci), Fo = schlick(f0c, co);
            V3 diff = m.base_color / kPi;
            diff = diff * plastic_diffuse_trans(m, ci, co);
            diff = diff * (V3{1, 1, 1} - Fi) * (V3{1, 1, 1} - Fo);
            diff = vmin0(diff * std::max(1.0f - m.coat_fresnel_avg, 0.0f));
            float pdf_d = ci / kPi;
            float pc = std::clamp(m.coat_sample_weight, 0.0f, 1.0f);
            r.value = spec + diff;
            r.pdf = pc * pdf_s + (1.0f - pc) * pdf_d;
            break;
        }
        default: {  // oracle fallback: lambert
            r.value = m.base_color / kPi;
            r.pdf = ci / kPi;
            break;
        }
    }
    if (r.pdf <= 0 || !finite3(r.value)) r.value = {0, 0, 0};
    return r;
}

SampleResult sample_bsdf(const Material& m, V3 pos, V3 n, V3 wo, V3 incident,
                         bool front, int sss_mode, uint32_t& s) {
    SampleResult r;
    switch (m.type) {
        case 5:
            return sample_subsurface_oracle(m, pos, n, wo, sss_mode, s);
        case 6:
            return sample_carpaint(m, pos, n, wo, s);
        case 0: {
            V3 local = cosine_hemisphere(s);
            V3 wi = normalize(to_world(local, n));
            float ci = dot(n, wi);
            if (ci <= 0) return r;
            float pdf = ci / kPi;
            if (pdf <= 0) return r;
            r.dir = wi;
            r.weight = m.base_color;
            r.pdf = r.dpdf = pdf;
            break;
        }
        case 1: {
            float rough = std::clamp(m.roughness, 0.f, 1.f);
            V3 f0 = conductor_f0(m);
            if (rough <= 1e-3f) {
                V3 wi = reflect(incident, n);
                if (dot(n, wi) <= 0) return r;
                float ct = std::max(dot(n, wo), 0.0f);
                r.weight = has_conductor(m)
                               ? fresnel_conductor(ct, m.conductor_eta, m.conductor_k)
                               : schlick(f0, ct);
                r.dir = wi;
                r.pdf = r.dpdf = 1.0f;
                r.delta = true;
                break;
            }
            float a = rough * rough;
            V3 wh = sample_vndf(n, wo, rough, s);
            if (dot(wh, n) <= 0) return r;
            V3 wi = normalize(reflect(wo * -1.0f, wh));
            float ci = dot(n, wi), co = dot(n, wo);
            if (ci <= 0 || co <= 0 || dot(wo, wh) <= 0) return r;
            float D = ggx_d(a, n, wh);
            float G = ggx_g1(a, co) * ggx_g1(a, ci);
            V3 F = has_conductor(m)
                       ? fresnel_conductor(dot(wi, wh), m.conductor_eta, m.conductor_k)
                       : schlick(f0, dot(wi, wh));
            V3 f = F * (D * G / std::max(4.0f * co * ci, 1e-6f));
            f = f * energy_comp(f0, rough, co);
            float pdf = ggx_pdf(a, n, wo, wi);
            if (pdf <= 0) return r;
            r.dir = wi;
            r.weight = vmin0(f * (ci / pdf));
            r.pdf = r.dpdf = pdf;
            break;
        }
        case 2: {
            bool thin = m.thin > 0.5f;
            float ref = std::max(m.eta, 1.0f);
            float ei = 1.0f, et = ref;
            if (!thin && !front) {
                ei = ref;
                et = 1.0f;
            }
            float co = std::clamp(dot(incident * -1.0f, n), -1.0f, 1.0f);
            float ct = 0;
            float Fr = fresnel_dielectric(co, ei, et, ct);
            V3 dir;
            V3 weight;
            if (rand_uniform(s) < Fr) {
                dir = reflect(incident, n);
                weight = {Fr, Fr, Fr};
            } else {
                dir = refract(incident, n, ei / et);
                if (dot(dir, dir) <= 0) {
                    dir = reflect(incident, n);
                    weight = {Fr, Fr, Fr};
                } else {
                    dir = normalize(dir);
                    float esc = (et * et) / (ei * ei);
                    float w = std::max(1.0f - Fr, 0.0f) * esc *
                              (std::fabs(ct) / std::max(std::fabs(co), 1e-6f));
                    weight = {w, w, w};
                    if (!thin) r.medium_event = front ? 1 : -1;
                }
            }
            r.dir = normalize(dir);
            r.weight = weight;
            r.pdf = r.dpdf = 1.0f;
            r.delta = true;
            break;
        }
        case 4: {
            float co = dot(n, wo);
            if (co <= 0) return r;
            float cr = std::max(std::clamp(m.coat_roughness, 0.f, 1.f), 1e-3f);
            float a = cr * cr;
            float f0 = plastic_coat_f0(m);
            V3 f0c = {f0, f0, f0};
            float pc = std::clamp(m.coat_sample_weight, 0.0f, 1.0f);
            float sel = rand_uniform(s);
            if (sel < pc && pc > 0) {
                V3 wh = sample_vndf(n, wo, cr, s);
                if (dot(wh, n) <= 0) return r;
                V3 wi = normalize(reflect(wo * -1.0f, wh));
                float ci = dot(n, wi);
                if (ci <= 0 || dot(wi, wh) <= 0) return r;
                float D = ggx_d(a, n, wh);
                float G = ggx_g1(a, co) * ggx_g1(a, ci);
                V3 F = schlick(f0c, dot(wi, wh));
                V3 spec = F * (D * G / std::max(4.0f * co * ci, 1e-6f));
                spec = spec * plastic_spec_tint(m);
                float ps = ggx_pdf(a, n, wo, wi);
                float pd = ci / kPi;
                float pdf = pc * ps + (1.0f - pc) * pd;
                if (pdf <= 0) return r;
                r.dir = wi;
                r.weight = vmin0(spec * (ci / pdf));
                r.pdf = r.dpdf = pdf;
            } else {
                V3 local = cosine_hemisphere(s);
                V3 wi = normalize(to_world(local, n));
                float ci = dot(n, wi);
                if (ci <= 0) return r;
                V3 diff = m.base_color / kPi;
                diff = diff * plastic_diffuse_trans(m, ci, co);
                V3 Fi = schlick(f0c, ci), Fo = schlick(f0c, co);
                diff = diff * (V3{1, 1, 1} - Fi) * (V3{1, 1, 1} - Fo);
                diff = vmin0(diff * std::max(1.0f - m.coat_fresnel_avg, 0.0f));
                float pd = ci / kPi;
                float ps = ggx_pdf(a, n, wo, wi);
                float pdf = pc * ps + (1.0f - pc) * pd;
                if (pdf <= 0) return r;
                r.dir = wi;
                r.weight = vmin0(diff * (ci / pdf));
                r.pdf = r.dpdf = pdf;
            }
            break;
        }
        case 7:
            return sample_pbr(m, n, wo, incident, s);
        default: {  // oracle fallback: lambert
            V3 local = cosine_hemisphere(s);
            V3 wi = normalize(to_world(local, n));
            float ci = dot(n, wi);
            if (ci <= 0) return r;
            r.dir = wi;
            r.weight = m.base_color;
            r.pdf = r.dpdf = ci / kPi;
            break;
        }
    }
    return r;
}

// ---- environment (reference: ops/env.py lookup convention) ---------------
V3 env_lookup(const Scene& sc, V3 dir) {
    V3 u = normalize(dir);
    float cr = std::cos(sc.env_rotation), sr = std::sin(sc.env_rotation);
    V3 rot = {u.x * cr - u.z * sr, u.y, u.x * sr + u.z * cr};
    float uu = (std::atan2(rot.z, rot.x) + kPi) / (2.0f * kPi);
    float vv = 0.5f - std::asin(std::clamp(rot.y, -1.0f, 1.0f)) / kPi;
    int w = sc.env_w, h = sc.env_h;
    // bilinear, repeat addressing (matches ops/env.py _bilinear_wrap)
    float x = uu * w - 0.5f, y = vv * h - 0.5f;
    int x0 = static_cast<int>(std::floor(x)), y0 = static_cast<int>(std::floor(y));
    float fx = x - x0, fy = y - y0;
    auto texel = [&](int yy, int xx) {
        yy = ((yy % h) + h) % h;
        xx = ((xx % w) + w) % w;
        const float* p = sc.env_texels + 3 * (yy * w + xx);
        return V3{p[0], p[1], p[2]};
    };
    V3 c = texel(y0, x0) * ((1 - fx) * (1 - fy)) + texel(y0, x0 + 1) * (fx * (1 - fy)) +
           texel(y0 + 1, x0) * ((1 - fx) * fy) + texel(y0 + 1, x0 + 1) * (fx * fy);
    return c * sc.env_intensity;
}
float env_pdf_lookup(const Scene& sc, V3 dir) {
    if (!sc.env_pdf) return 0;
    V3 u = normalize(dir);
    float cr = std::cos(sc.env_rotation), sr = std::sin(sc.env_rotation);
    V3 rot = {u.x * cr - u.z * sr, u.y, u.x * sr + u.z * cr};
    float uu = (std::atan2(rot.z, rot.x) + kPi) / (2.0f * kPi);
    float vv = 0.5f - std::asin(std::clamp(rot.y, -1.0f, 1.0f)) / kPi;
    uu = std::clamp(uu, 0.0f, 0.99999994f);
    vv = std::clamp(vv, 0.0f, 0.99999994f);
    int x = std::min(static_cast<int>(uu * sc.env_w), sc.env_w - 1);
    int y = std::min(static_cast<int>(vv * sc.env_h), sc.env_h - 1);
    float p = sc.env_pdf[y * sc.env_w + x];
    return (std::isfinite(p) && p > 0) ? p : 0;
}
bool env_sample(const Scene& sc, uint32_t& s, V3& dir, V3& rad, float& pdf) {
    if (!sc.env_pdf) return false;
    int w = sc.env_w, h = sc.env_h;
    float um = rand_uniform(s), uc = rand_uniform(s), uj = rand_uniform(s);
    float rc = um * h;
    int row = std::min(static_cast<int>(std::floor(rc)), h - 1);
    if (rc - std::floor(rc) >= sc.marg_thresh[row])
        row = std::min(sc.marg_alias[row], h - 1);
    float cc = uc * w;
    int col = std::min(static_cast<int>(std::floor(cc)), w - 1);
    if (cc - std::floor(cc) >= sc.cond_thresh[row * w + col])
        col = std::min(sc.cond_alias[row * w + col], w - 1);
    float fx = (col + (uc - std::floor(uc))) / w;
    float fy = (row + std::clamp(uj, 0.0f, 0.99999994f)) / h;
    float theta = fy * kPi;
    float phi = fx * 2.0f * kPi - kPi;  // lookup-consistent convention
    float st = std::sin(theta), ct = std::cos(theta);
    V3 map_dir = {st * std::cos(phi), ct, st * std::sin(phi)};
    float cr = std::cos(sc.env_rotation), sr = std::sin(sc.env_rotation);
    dir = {map_dir.x * cr + map_dir.z * sr, map_dir.y,
           -map_dir.x * sr + map_dir.z * cr};
    pdf = sc.env_pdf[row * w + col];
    if (!std::isfinite(pdf) || pdf <= 0) return false;
    // Texel-exact NEE radiance: the sampled texel's own value (the one the
    // pdf was built from) instead of re-projecting the jittered direction
    // through a bilinear lookup — twin of ops/env.py _use_texel_nee
    // (deviation from pathtrace.metal:1543-1573 documented there).
    const float* tp = sc.env_texels + 3 * (static_cast<size_t>(row) * w + col);
    rad = vmin0(V3{tp[0], tp[1], tp[2]} * sc.env_intensity);
    return finite3(rad);
}

// ---- rect light sampling (reference: pathtrace.metal sample_rect_light) --
bool rect_light_sample(const Scene& sc, const Hit& hit, uint32_t& s,
                       V3& dir, float& dist, float& pdf, V3& emission) {
    int nl = static_cast<int>(sc.light_rects.size());
    if (nl == 0) return false;
    int sel = std::min(static_cast<int>(rand_uniform(s) * nl), nl - 1);
    int ri = sc.light_rects[sel];
    float u = rand_uniform(s), v = rand_uniform(s);
    const float* r = sc.rect + 15 * ri;
    V3 eu = {r[3], r[4], r[5]}, ev = {r[6], r[7], r[8]};
    V3 p = V3{r[0], r[1], r[2]} + eu * u + ev * v;
    V3 to = p - hit.point;
    float d2 = dot(to, to);
    if (d2 <= 0) return false;
    dist = std::sqrt(d2);
    dir = to / dist;
    float area = length(cross(eu, ev));
    if (area <= 0) return false;
    V3 n = {r[11], r[12], r[13]};
    float cl = dot(dir * -1.0f, n);
    bool two = sc.rect_two_sided[ri] != 0;
    if (two) cl = std::fabs(cl);
    else if (cl <= 0) return false;
    if (cl <= 0) return false;
    pdf = (1.0f / area) * d2 / std::max(cl, 1e-6f) / nl;
    if (pdf <= 0 || !std::isfinite(pdf)) return false;
    emission = sc.mats[sc.rect_mat[ri]].emission;
    return maxc(emission) > 0 || emission.x != 0 || emission.y != 0 || emission.z != 0;
}
float rect_light_pdf_hit(const Scene& sc, const Hit& h, V3 origin) {
    int nl = static_cast<int>(sc.light_rects.size());
    if (nl == 0 || h.prim_type != 2) return 0;
    const Material& m = sc.mats[sc.rect_mat[h.prim]];
    if (m.type != 3 || (m.emission.x == 0 && m.emission.y == 0 && m.emission.z == 0))
        return 0;
    const float* r = sc.rect + 15 * h.prim;
    V3 eu = {r[3], r[4], r[5]}, ev = {r[6], r[7], r[8]};
    float area = length(cross(eu, ev));
    if (area <= 0) return 0;
    V3 to = h.point - origin;
    float d2 = dot(to, to);
    if (d2 <= 0) return 0;
    V3 dir = to / std::sqrt(d2);
    V3 n = {r[11], r[12], r[13]};
    float cl = dot(dir * -1.0f, n);
    if (sc.rect_two_sided[h.prim]) cl = std::fabs(cl);
    else if (cl <= 0) return 0;
    if (cl <= 0) return 0;
    return (1.0f / area) * d2 / std::max(cl, 1e-6f) / nl;
}

// ---- path integrator (mirrors ops/integrator.py / reference :5717-7284) --
struct Params {
    int width, height, spp, max_depth;
    uint32_t seed;
    int use_rr;
    float cam[19];  // origin, lower_left, horizontal, vertical, u, v, lens_r
    int bg_mode;
    V3 bg_color;
    Clamps clamps;
    int enable_spec_nee;
    int enable_mnee = 0;
    int enable_mnee_secondary = 0;
    int sss_mode = 0;
    int sss_max_steps = 32;
    int ao_indirect_only = 1;
};

V3 sky(V3 d) {
    V3 u = normalize(d);
    float t = 0.5f * (u.y + 1.0f);
    return V3{1, 1, 1} * (1.0f - t) + V3{0.5f, 0.7f, 1.0f} * t;
}

V3 trace_path(const Scene& sc, const Params& P, V3 ro, V3 rd, uint32_t& s) {
    V3 throughput = {1, 1, 1};
    V3 radiance = {0, 0, 0};
    float last_pdf = 1.0f;
    bool last_delta = true;
    int exclude_tri = -1;
    int spec_depth = 0;  // consecutive delta bounces (mnee eligibility)
    V3 medium[kMaxMedium];
    int medium_depth = 0;
    bool env_on = P.bg_mode == 2 && sc.env_pdf != nullptr;

    for (int depth = 0; depth < P.max_depth; ++depth) {
        Hit rec;
        if (!trace(sc, ro, rd, kEpsilon, kInfinity, exclude_tri, rec)) {
            V3 bg = P.bg_mode == 1 ? P.bg_color
                    : (P.bg_mode == 2 && sc.env_texels ? env_lookup(sc, rd)
                                                       : sky(rd));
            float mis = 1.0f;
            bool use_mis = !last_delta || P.enable_spec_nee;
            if (use_mis && env_on) {
                float lp = env_pdf_lookup(sc, rd);
                float den = last_pdf + lp;
                if (den > 0)
                    mis = std::clamp(last_pdf / den, kMisMin, kMisMax);
            }
            radiance = radiance + clamp_contribution(throughput, bg * mis, P.clamps);
            break;
        }
        exclude_tri = rec.prim_type == 3 ? rec.prim : -1;

        if (medium_depth > 0) {
            V3 sg = medium[medium_depth - 1];
            if (maxc(sg) > 0)
                throughput = throughput * vexp(sg * -std::max(rec.t, 0.0f));
        }

        V3 n_mapped;
        Material m = textured_material(sc, rec, n_mapped);
        // AO applies to indirect bounces only under the default config
        // (ops/pbr_textures.py debug_ao_indirect_only; settings default)
        if (depth == 0 && P.ao_indirect_only) m.occlusion = 1.0f;
        V3 incident = normalize(rd);
        V3 wo = incident * -1.0f;
        V3 n = n_mapped;

        // PBR emissive additive — does not terminate the path
        // (ops/integrator.py PBR emissive block; reference :6437-6442)
        if (m.type == 7 &&
            (m.emission.x != 0 || m.emission.y != 0 || m.emission.z != 0) &&
            (rec.front || rec.two_sided || m.pbr_double_sided > 0.5f)) {
            radiance = radiance + clamp_contribution(throughput, m.emission, P.clamps);
        }

        // DiffuseLight hit (reference :6444-6485)
        if (m.type == 3) {
            V3 em = m.emission;
            if ((em.x != 0 || em.y != 0 || em.z != 0) && (rec.front || rec.two_sided)) {
                float mis = 1.0f;
                bool use_mis = !last_delta || P.enable_spec_nee;
                if (use_mis && !sc.light_rects.empty()) {
                    float lp = rect_light_pdf_hit(sc, rec, ro);
                    float den = last_pdf + lp;
                    if (den > 0) mis = std::clamp(last_pdf / den, kMisMin, kMisMax);
                }
                radiance = radiance + clamp_contribution(throughput, em * mis, P.clamps);
            }
            break;
        }

        bool is_delta_surface = material_is_delta(m);

        // NEE rect lights
        if (!is_delta_surface && !sc.light_rects.empty()) {
            V3 ldir, lem;
            float ldist, lpdf;
            if (rect_light_sample(sc, rec, s, ldir, ldist, lpdf, lem)) {
                float ndl = std::max(dot(n, ldir), 0.0f);
                if (lpdf > 0 && ndl > 0) {
                    Hit sh;
                    V3 so = offset_origin(rec, ldir);
                    bool occ = trace(sc, so, ldir, kEpsilon,
                                     std::max(ldist - kEpsilon, kEpsilon), -1, sh);
                    if (!occ) {
                        EvalResult ev = eval_bsdf(m, rec.point, n, wo, ldir);
                        if (!ev.delta && maxc(ev.value) > 0) {
                            float wgt = 1.0f;
                            if (ev.pdf > 0) {
                                float den = lpdf + ev.pdf;
                                if (den > 0)
                                    wgt = std::clamp(lpdf / den, kMisMin, kMisMax);
                            }
                            V3 contrib = lem * ev.value * (ndl * wgt / lpdf);
                            if (finite3(contrib))
                                radiance = radiance +
                                           clamp_contribution(throughput, contrib, P.clamps);
                        }
                    }
                }
            }
        }

        // NEE environment
        if (!is_delta_surface && env_on) {
            V3 edir, erad;
            float epdf;
            if (env_sample(sc, s, edir, erad, epdf)) {
                float ndl = std::max(dot(n, edir), 0.0f);
                if (epdf > 0 && ndl > 0) {
                    Hit sh;
                    V3 so = offset_origin(rec, edir);
                    bool occ = trace(sc, so, edir, kEpsilon, kInfinity, -1, sh);
                    if (!occ) {
                        EvalResult ev = eval_bsdf(m, rec.point, n, wo, edir);
                        if (!ev.delta && maxc(ev.value) > 0) {
                            float wgt = 1.0f;
                            if (ev.pdf > 0) {
                                float den = epdf + ev.pdf;
                                if (den > 0)
                                    wgt = std::clamp(epdf / den, kMisMin, kMisMax);
                            }
                            V3 contrib = erad * ev.value * (ndl * wgt / epdf);
                            if (finite3(contrib))
                                radiance = radiance +
                                           clamp_contribution(throughput, contrib, P.clamps);
                        }
                    }
                }
            }
        }

        SampleResult smp;
        bool rw_lane = P.sss_mode == 2 && m.type == 5 && m.ss_method >= 0.5f &&
                       rec.front;
        if (rw_lane) {
            // mirror ops/integrator.py: the lambert fallback sample and the
            // random walk both start from the same RNG state; the walk wins
            // when it produced a valid exit, else the fallback (and its
            // post-draw state) stands.
            uint32_t s0 = s;
            SampleResult fb =
                sample_bsdf(m, rec.point, n, wo, incident, rec.front, P.sss_mode, s);
            uint32_t s_fb = s;
            s = s0;
            SampleResult rw = sample_sss_walk_oracle(sc, m, rec, wo, incident,
                                                     P.sss_max_steps, s);
            if (rw.pdf > 0) {
                smp = rw;
            } else {
                smp = fb;
                s = s_fb;
            }
        } else {
            smp = sample_bsdf(m, rec.point, n, wo, incident, rec.front,
                              P.sss_mode, s);
        }
        if (smp.pdf <= 0) break;

        if (smp.medium_event == 1) {
            V3 sg = vmin0(m.sigma_a);
            if (medium_depth < kMaxMedium)
                medium[medium_depth++] = sg;
            else
                medium[kMaxMedium - 1] = sg;
        } else if (smp.medium_event == -1) {
            if (medium_depth > 0) medium_depth--;
        }

        V3 next_o;
        if (smp.has_exit) {
            // BSSRDF exit restart (ops/integrator.py; reference :6741-6766)
            V3 en = smp.exit_normal;
            if (!(finite3(en) && dot(en, en) > 0.0f)) en = rec.normal;
            en = normalize(en);
            float sign = dot(smp.dir, en) >= 0.0f ? 1.0f : -1.0f;
            next_o = smp.exit_point + en * (sign * kRayOriginEpsilon);
            next_o = next_o + en * (kRayOriginEpsilon * 32.0f);
            next_o = next_o + normalize(smp.dir) * (kRayOriginEpsilon * 32.0f);
        } else {
            next_o = offset_origin(rec, smp.dir);
        }

        // ---- specular-NEE / "MNEE" delta chains ----------------------
        // Mirrors ops/specnee.py (reference :6770-7235 + mnee.metal):
        // primary chain for spec- or mnee-eligible delta bounces, plus the
        // 2-bounce secondary chain through a second delta surface.
        int next_spec_depth = smp.delta ? spec_depth + 1 : 0;
        bool dir_valid = finite3(smp.dir) && dot(smp.dir, smp.dir) > 0;
        // didTransmission (reference :6727-6738): delta dielectric bounce
        // that crossed the surface (shading normal == geometric for
        // dielectrics on both sides of the parity gate)
        float side = rec.front ? 1.0f : -1.0f;
        bool did_trans = m.type == 2 && smp.delta && dot(n, smp.dir) * side < 0;
        bool mnee_eligible = P.enable_mnee && smp.delta &&
                             (smp.medium_event <= 0 || did_trans) &&
                             m.type == 2 && next_spec_depth == 1 && dir_valid;
        bool spec_eligible = P.enable_spec_nee && smp.delta &&
                             smp.medium_event <= 0 && dir_valid && !mnee_eligible;

        // one env + one rect estimator along a chain direction, MIS'd with
        // the chain's combined bsdf pdf (ops/specnee.py env/rect_estimator)
        auto chain_estimators = [&](V3 origin, V3 nd, V3 weight, float bpdf) {
            if (env_on) {
                Hit sh;
                bool occ = trace(sc, origin, nd, kEpsilon, kInfinity, -1, sh);
                if (!occ) {
                    float ep = std::max(env_pdf_lookup(sc, nd), 1.0e-4f);
                    float inv = std::min(1.0f / ep, 1.0e4f);
                    float bp = std::max(bpdf, 1.0e-4f);
                    float wgt = std::clamp(ep / (ep + bp), kMisMin, kMisMax);
                    V3 contrib = weight * env_lookup(sc, nd) * (wgt * inv);
                    if (finite3(contrib))
                        radiance = radiance +
                                   clamp_contribution(throughput, contrib, P.clamps);
                }
            }
            if (!sc.light_rects.empty()) {
                Hit lh;
                if (trace(sc, origin, nd, kEpsilon, kInfinity, -1, lh) &&
                    lh.prim_type == 2) {
                    const Material& lm = sc.mats[sc.rect_mat[lh.prim]];
                    if (lm.type == 3 && (lh.front || lh.two_sided)) {
                        float lp = rect_light_pdf_hit(sc, lh, origin);
                        if (lp > 0) {
                            lp = std::max(lp, 1.0e-4f);
                            float inv = std::min(1.0f / lp, 1.0e4f);
                            float bp = std::max(bpdf, 1.0e-4f);
                            float wgt = std::clamp(lp / (lp + bp), kMisMin, kMisMax);
                            V3 contrib = weight * lm.emission * (wgt * inv);
                            if (finite3(contrib))
                                radiance = radiance + clamp_contribution(
                                                          throughput, contrib, P.clamps);
                        }
                    }
                }
            }
        };

        if (spec_eligible || mnee_eligible) {
            V3 nd = normalize(smp.dir);
            chain_estimators(next_o, nd, smp.weight, smp.dpdf);

            // secondary chain (ops/specnee.py; reference :7060-7232):
            // follow the delta direction through one more delta surface
            if (mnee_eligible && P.enable_mnee_secondary) {
                Hit ch;
                if (trace(sc, next_o, nd, kEpsilon, kInfinity, -1, ch)) {
                    bool hit_is_light = false;
                    if (ch.prim_type == 2 && !sc.light_rects.empty()) {
                        const Material& lm = sc.mats[sc.rect_mat[ch.prim]];
                        hit_is_light =
                            lm.type == 3 &&
                            (lm.emission.x != 0 || lm.emission.y != 0 ||
                             lm.emission.z != 0) &&
                            (ch.front || ch.two_sided) &&
                            rect_light_pdf_hit(sc, ch, next_o) > 0;
                    }
                    const Material& m2 =
                        sc.mats[std::min(ch.mat, (int)sc.mats.size() - 1)];
                    if (!hit_is_light && material_is_delta(m2)) {
                        V3 cn = ch.normal;
                        if (!(finite3(cn) && dot(cn, cn) > 0)) cn = {0, 1, 0};
                        cn = normalize(cn);
                        V3 c_in = normalize(nd);
                        V3 c_wo = c_in * -1.0f;
                        // reference samples with an RNG *copy* (:7113)
                        uint32_t s2 = s;
                        SampleResult cs = sample_bsdf(m2, ch.point, cn, c_wo,
                                                      c_in, ch.front,
                                                      P.sss_mode, s2);
                        V3 cd = cs.dir;
                        float cd2 = dot(cd, cd);
                        if (cs.pdf > 0 && cs.delta && cs.medium_event <= 0 &&
                            finite3(cd) && cd2 > 0) {
                            cd = cd / std::sqrt(cd2);
                            V3 c_origin = offset_origin(ch, cd);
                            V3 cw = smp.weight * cs.weight;
                            float cpdf = std::max(smp.dpdf * cs.dpdf, 1.0e-4f);
                            chain_estimators(c_origin, cd, cw, cpdf);
                        }
                    }
                }
            }
        }
        spec_depth = next_spec_depth;

        throughput = clamp_throughput(throughput * smp.weight, P.clamps);
        if (!finite3(throughput)) break;
        float mtp = maxc(throughput);
        if (mtp <= 0) break;

        last_pdf = smp.dpdf > 0 ? smp.dpdf : smp.pdf;
        last_delta = smp.delta;
        ro = next_o;
        rd = smp.dir;

        if (P.use_rr && depth >= 5) {
            float cp = std::clamp(mtp, 0.05f, 0.95f);
            if (rand_uniform(s) > cp) break;
            throughput = throughput / cp;
        }
    }
    return radiance;
}

}  // namespace

extern "C" int render_oracle(
    int width, int height, int spp, int max_depth, uint32_t seed, int use_rr,
    const float* cam,  // 19 floats
    int bg_mode, const float* bg_color,
    int n_spheres, const float* sph, const int* sph_mat,
    int n_rects, const float* rect, const int* rect_mat, const int* rect_two_sided,
    int n_tris, const float* tri, const int* tri_mat,
    const float* tri_uv,  // (T,6) per-corner uv0 (null = untextured)
    const float* tri_tan,  // (T,12) per-corner tangent xyzw (null = none)
    int n_textures, int tex_size, const float* tex_data, const int* tex_wrap,
    int n_mats, const float* mat_data,  // (M, 72)
    int env_w, int env_h, const float* env_texels,
    const float* marg_thresh, const int* marg_alias,
    const float* cond_thresh, const int* cond_alias, const float* env_pdf,
    float env_rotation, float env_intensity,
    const float* firefly,  // factor, floor, throughput, max_contrib, enabled
    int enable_spec_nee, int enable_mnee, int enable_mnee_secondary,
    int sss_mode, int sss_max_steps, int ao_indirect_only, int n_threads,
    float* out_rgb) {
    Scene sc;
    sc.n_spheres = n_spheres;
    sc.sph = sph;
    sc.sph_mat = sph_mat;
    sc.n_rects = n_rects;
    sc.rect = rect;
    sc.rect_mat = rect_mat;
    sc.rect_two_sided = rect_two_sided;
    sc.n_tris = n_tris;
    sc.tri = tri;
    sc.tri_mat = tri_mat;
    sc.tri_uv = tri_uv;
    sc.tri_tan = tri_tan;
    sc.n_textures = n_textures;
    sc.tex_size = tex_size;
    sc.tex_data = tex_data;
    sc.tex_wrap = tex_wrap;
    sc.env_w = env_w;
    sc.env_h = env_h;
    sc.env_texels = env_texels;
    sc.marg_thresh = marg_thresh;
    sc.marg_alias = marg_alias;
    sc.cond_thresh = cond_thresh;
    sc.cond_alias = cond_alias;
    sc.env_pdf = env_pdf;
    sc.env_rotation = env_rotation;
    sc.env_intensity = env_intensity;

    sc.mats.resize(n_mats);
    for (int i = 0; i < n_mats; ++i) {
        const float* d = mat_data + 72 * i;
        Material& m = sc.mats[i];
        m.base_color = {std::clamp(d[0], 0.f, 1.f), std::clamp(d[1], 0.f, 1.f),
                        std::clamp(d[2], 0.f, 1.f)};
        m.roughness = d[3];
        m.type = static_cast<int>(d[4]);
        m.eta = d[5];
        m.thin = d[6];
        m.emission = {d[7], d[8], d[9]};
        m.emission_env = d[10];
        m.conductor_eta = {d[11], d[12], d[13]};
        m.conductor_k = {d[14], d[15], d[16]};
        m.has_conductor = d[17];
        m.sigma_a = {d[18], d[19], d[20]};
        m.coat_roughness = d[21];
        m.coat_thickness = d[22];
        m.coat_sample_weight = d[23];
        m.coat_fresnel_avg = d[24];
        m.coat_tint = {d[25], d[26], d[27]};
        m.coat_absorption = {d[28], d[29], d[30]};
        m.coat_ior = d[31];
        m.pbr_metallic = d[32];
        m.pbr_transmission = d[33];
        m.pbr_thickness = d[34];
        m.pbr_double_sided = d[35];
        m.cp_base_metallic = d[36];
        m.cp_base_roughness = d[37];
        m.cp_flake_scale = d[38];
        m.cp_flake_sample_weight = d[39];
        m.cp_flake_roughness = d[40];
        m.cp_flake_anisotropy = d[41];
        m.cp_flake_normal_strength = d[42];
        m.cp_base_eta = {d[43], d[44], d[45]};
        m.cp_base_k = {d[46], d[47], d[48]};
        m.cp_has_base_conductor = d[49];
        m.ss_a = {d[50], d[51], d[52]};
        m.ss_s = {d[53], d[54], d[55]};
        m.ss_mfp = d[56];
        m.ss_g = d[57];
        m.ss_method = d[58];
        m.ss_coat = d[59];
        m.ss_override = d[60];
        m.base_tex = (int)d[61];
        m.orm_tex = (int)d[62];
        m.normal_tex = (int)d[63];
        m.occ_tex = (int)d[64];
        m.em_tex = (int)d[65];
        m.trans_tex = (int)d[66];
        m.occlusion_strength = d[67];
        m.normal_scale = d[68];
        m.mat_flags = (int)d[69];
    }
    for (int i = 0; i < n_rects; ++i) {
        const Material& m = sc.mats[std::min(rect_mat[i], n_mats - 1)];
        if (m.type == 3 && (m.emission.x != 0 || m.emission.y != 0 || m.emission.z != 0))
            sc.light_rects.push_back(i);
    }

    // build the triangle BVH with the shared native builder
    if (n_tris > 0) {
        int max_nodes = std::max(2 * n_tris, 2);
        std::vector<float> bmin(max_nodes * 3), bmax(max_nodes * 3);
        std::vector<int32_t> off(max_nodes), cnt(max_nodes), ex(max_nodes),
            prims(n_tris);
        int n_nodes = build_bvh_sah(n_tris, tri, bmin.data(), bmax.data(),
                                    off.data(), cnt.data(), ex.data(),
                                    prims.data(), 4, 16);
        if (n_nodes <= 0) return -1;
        sc.bvh_min.assign(bmin.begin(), bmin.begin() + 3 * n_nodes);
        sc.bvh_max.assign(bmax.begin(), bmax.begin() + 3 * n_nodes);
        sc.bvh_off.assign(off.begin(), off.begin() + n_nodes);
        sc.bvh_cnt.assign(cnt.begin(), cnt.begin() + n_nodes);
        sc.bvh_exit.assign(ex.begin(), ex.begin() + n_nodes);
        sc.bvh_prims.assign(prims.begin(), prims.end());
    }

    Params P;
    P.width = width;
    P.height = height;
    P.spp = spp;
    P.max_depth = max_depth;
    P.seed = seed;
    P.use_rr = use_rr;
    std::memcpy(P.cam, cam, sizeof(float) * 19);
    P.bg_mode = bg_mode;
    P.bg_color = {bg_color[0], bg_color[1], bg_color[2]};
    P.clamps = {firefly[0], firefly[1], firefly[2], firefly[3], firefly[4]};
    P.enable_spec_nee = enable_spec_nee;
    P.enable_mnee = enable_mnee;
    P.enable_mnee_secondary = enable_mnee_secondary;
    P.sss_mode = sss_mode;
    P.sss_max_steps = sss_max_steps;
    P.ao_indirect_only = ao_indirect_only;

    V3 cam_origin = {cam[0], cam[1], cam[2]};
    V3 lower_left = {cam[3], cam[4], cam[5]};
    V3 horizontal = {cam[6], cam[7], cam[8]};
    V3 vertical = {cam[9], cam[10], cam[11]};
    V3 cam_u = {cam[12], cam[13], cam[14]};
    V3 cam_v = {cam[15], cam[16], cam[17]};
    float lens_r = cam[18];

    // 16x16 tiles, atomic work index (reference backend scheduling)
    const int tile = 16;
    int tx = (width + tile - 1) / tile, ty = (height + tile - 1) / tile;
    std::atomic<int> next{0};
    int workers = n_threads > 0
                      ? n_threads
                      : static_cast<int>(std::thread::hardware_concurrency());
    workers = std::max(workers, 1);

    auto work = [&]() {
        while (true) {
            int t = next.fetch_add(1);
            if (t >= tx * ty) break;
            int x0 = (t % tx) * tile, y0 = (t / tx) * tile;
            for (int y = y0; y < std::min(y0 + tile, height); ++y) {
                for (int x = x0; x < std::min(x0 + tile, width); ++x) {
                    V3 sum = {0, 0, 0};
                    for (int sidx = 0; sidx < spp; ++sidx) {
                        // seed recipe (reference: pathtrace.metal:9735-9740);
                        // frameIndex == sampleCount == previousCount == sidx
                        uint32_t s = P.seed + static_cast<uint32_t>(sidx) * 9781u +
                                     static_cast<uint32_t>(x) * 6271u +
                                     static_cast<uint32_t>(y) * 13007u +
                                     2u * static_cast<uint32_t>(sidx) * 211u;
                        float ju = rand_uniform(s);
                        float u = (x + ju) / width;
                        float jv = rand_uniform(s);
                        float v = 1.0f - (y + jv) / height;
                        float dx, dy;
                        disk_sample(s, dx, dy);
                        V3 off = cam_u * (lens_r * dx) + cam_v * (lens_r * dy);
                        V3 ro = cam_origin + off;
                        V3 rd = lower_left + horizontal * u + vertical * v - ro;
                        V3 rad = trace_path(sc, P, ro, rd, s);
                        if (finite3(rad)) sum = sum + vmin0(rad);
                    }
                    float invs = 1.0f / std::max(spp, 1);
                    float* o = out_rgb + 3 * (y * width + x);
                    o[0] = sum.x * invs;
                    o[1] = sum.y * invs;
                    o[2] = sum.z * invs;
                }
            }
        }
    };
    std::vector<std::thread> threads;
    for (int i = 1; i < workers; ++i) threads.emplace_back(work);
    work();
    for (auto& th : threads) th.join();
    return 0;
}
