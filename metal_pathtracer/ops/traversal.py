"""BVH traversal + Möller–Trumbore over the triangle soup.

A re-design of the reference's stack-based software traversal
(reference: shaders/pathtrace.metal traverse_bvh_triangles:1852-1970,
trace_scene_tlas_triangles:2167-2384): instead of a per-thread 128-entry
stack, the BVH is flattened depth-first with **exit links**
(scene/meshbuild.py), so every lane runs the same loop

    node = hit(aabb) ? (leaf ? test prims, exit : node+1) : exit

with one node pointer per lane and no stack.

Two routes run that walk, chosen once per scene when its arrays are built
(scene/resources.py): the Pallas kernel in ops/pallas/traverse.py (one
lane per ray, the loop inside the kernel) when the scene carries
`tri_kernel` tables, and otherwise the `lax.while_loop` below, which is
the plain-XLA reference. Both evaluate the same slab test and
Möller–Trumbore arithmetic (`slab_test`, `moller_trumbore`), so they
differ only where the compilers contract multiply-adds differently: by an
ulp of t, u, v on the CPU, not at all on the H100 measured so far.

Self-hit exclusion by (mesh, primitive) id matches
compute_exclusion_indices (reference: pathtrace.metal:258-269).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from metal_pathtracer.constants import (
    INFINITY_T,
    PRIMITIVE_TRIANGLE,
)
from metal_pathtracer.ops.intersect import HitRecord
from metal_pathtracer.ops.vecmath import dot, safe_normalize, where3
from metal_pathtracer.scene.meshbuild import MAX_LEAF


def default_route() -> str:
    """The traversal route a scene gets when build_arrays names none: the
    kernel on a GPU, the XLA loop on any other platform. A
    `jax.default_device(...)` override counts (a CPU render inside a GPU
    process takes the XLA route)."""
    device = jax.config.jax_default_device
    if device is None:
        platform = jax.default_backend()
    else:
        platform = getattr(device, "platform", device)
    return "kernel" if platform == "gpu" else "xla"


def safe_inv_dir(d):
    """1/d with near-zero components pushed to +-1e-20 (finite slabs)."""
    return 1.0 / jnp.where(jnp.abs(d) < 1e-20,
                           jnp.where(d >= 0, 1e-20, -1e-20), d)


def slab_test(o, inv, bmin, bmax, t_min, t_max):
    """Ray/AABB slab test on xyz component tuples; True where the box
    overlaps [t_min, t_max]."""
    tnear = t_min
    tfar = t_max
    for a in range(3):
        t0 = (bmin[a] - o[a]) * inv[a]
        t1 = (bmax[a] - o[a]) * inv[a]
        tnear = jnp.maximum(tnear, jnp.minimum(t0, t1))
        tfar = jnp.minimum(tfar, jnp.maximum(t0, t1))
    return tfar >= tnear


def moller_trumbore(o, d, a, b, c, t_min, t_max):
    """Möller–Trumbore on xyz component tuples (reference: pathtrace.metal
    intersect_triangle_parametric:544-592). Returns (t, u, v, valid)."""
    e1 = (b[0] - a[0], b[1] - a[1], b[2] - a[2])
    e2 = (c[0] - a[0], c[1] - a[1], c[2] - a[2])
    p = (d[1] * e2[2] - d[2] * e2[1],
         d[2] * e2[0] - d[0] * e2[2],
         d[0] * e2[1] - d[1] * e2[0])
    det = e1[0] * p[0] + e1[1] * p[1] + e1[2] * p[2]
    inv_det = 1.0 / jnp.where(jnp.abs(det) < 1e-8, 1.0, det)
    s = (o[0] - a[0], o[1] - a[1], o[2] - a[2])
    u = (s[0] * p[0] + s[1] * p[1] + s[2] * p[2]) * inv_det
    q = (s[1] * e1[2] - s[2] * e1[1],
         s[2] * e1[0] - s[0] * e1[2],
         s[0] * e1[1] - s[1] * e1[0])
    v = (d[0] * q[0] + d[1] * q[1] + d[2] * q[2]) * inv_det
    t = (e2[0] * q[0] + e2[1] * q[1] + e2[2] * q[2]) * inv_det
    valid = ((jnp.abs(det) >= 1e-8)
             & (u >= 0.0) & (u <= 1.0)
             & (v >= 0.0) & (u + v <= 1.0)
             & (t >= t_min) & (t <= t_max))
    return t, u, v, valid


def _xyz(x):
    return x[..., 0], x[..., 1], x[..., 2]


def _lane_args(origin, t_min, t_max, exclude_mesh, exclude_prim):
    shape = origin.shape[:-1]
    f32 = lambda x: jnp.broadcast_to(jnp.asarray(x, jnp.float32), shape)
    i32 = lambda x: jnp.broadcast_to(
        jnp.asarray(-1 if x is None else x, jnp.int32), shape)
    return f32(t_min), f32(t_max), i32(exclude_mesh), i32(exclude_prim)


def trace_best(origin, direction, tris, bvh, tables, t_min, t_max,
               exclude_mesh=None, exclude_prim=None, any_hit=False):
    """Closest (or, with any_hit, first found) hit of each lane against one
    BVH. Returns (t, tri, u, v); tri is -1 where nothing was hit.

    `tables` (schema.TraversalTables or None) selects the route: the
    Pallas kernel when present, else the XLA while-loop."""
    t_min, t_max, exclude_mesh, exclude_prim = _lane_args(
        origin, t_min, t_max, exclude_mesh, exclude_prim)
    if tables is not None:
        from metal_pathtracer.ops.pallas import traverse as kernel
        return kernel.trace(tables, origin, direction, t_min, t_max,
                            exclude_mesh, exclude_prim, any_hit=any_hit)
    return _trace_xla(origin, direction, tris, bvh, t_min, t_max,
                      exclude_mesh, exclude_prim)


def _trace_xla(origin, direction, tris, bvh, t_min, t_max, exclude_mesh,
               exclude_prim):
    """The plain-XLA route: one `lax.while_loop` step advances every lane
    by one node, until the slowest lane of the wavefront is done."""
    shape = origin.shape[:-1]
    n_nodes = bvh.node_count
    o = _xyz(origin)
    d = _xyz(direction)
    inv = _xyz(safe_inv_dir(direction))
    ok = (slice(None),) * len(shape) + (None,)   # lane -> (lane, slot)
    o_k = tuple(c[ok] for c in o)
    d_k = tuple(c[ok] for c in d)

    def cond(state):
        node, *_ = state
        return jnp.any(node < n_nodes)

    def body(state):
        node, best_t, best_tri, best_u, best_v = state
        nd = jnp.minimum(node, n_nodes - 1)
        box_hit = slab_test(o, inv, _xyz(bvh.bounds_min[nd]),
                            _xyz(bvh.bounds_max[nd]), t_min, best_t)
        pcount = bvh.prim_count[nd]
        is_leaf = pcount > 0
        active = node < n_nodes

        # Leaf: test up to MAX_LEAF reordered primitive slots (masked)
        do_leaf = active & box_hit & is_leaf
        poff = bvh.prim_offset[nd]
        slot = poff[..., None] + jnp.arange(MAX_LEAF)
        slot_valid = (jnp.arange(MAX_LEAF) < pcount[..., None]) \
            & do_leaf[..., None]
        slot = jnp.clip(slot, 0, bvh.prim_indices.shape[0] - 1)
        tri_ids = bvh.prim_indices[slot]
        t, u, v, valid = moller_trumbore(
            o_k, d_k, _xyz(tris.v0[tri_ids]), _xyz(tris.v1[tri_ids]),
            _xyz(tris.v2[tri_ids]), t_min[ok], best_t[ok])
        excl = ((tris.mesh_index[tri_ids] == exclude_mesh[ok])
                & (tri_ids == exclude_prim[ok]))
        valid = valid & slot_valid & jnp.logical_not(excl)
        t_masked = jnp.where(valid, t, INFINITY_T)
        k = jnp.argmin(t_masked, -1)[..., None]
        t_hit = jnp.take_along_axis(t_masked, k, -1)[..., 0]
        improved = jnp.any(valid, -1) & (t_hit < best_t)
        pick = lambda x: jnp.take_along_axis(x, k, -1)[..., 0]
        best_t = jnp.where(improved, t_hit, best_t)
        best_tri = jnp.where(improved, pick(tri_ids), best_tri)
        best_u = jnp.where(improved, pick(u), best_u)
        best_v = jnp.where(improved, pick(v), best_v)

        # Advance: internal hit -> next node (node+1); otherwise exit link.
        descend = active & box_hit & jnp.logical_not(is_leaf)
        next_node = jnp.where(descend, nd + 1, bvh.exit_index[nd])
        node = jnp.where(active, next_node, node)
        return node, best_t, best_tri, best_u, best_v

    state = (jnp.zeros(shape, jnp.int32), t_max,
             jnp.full(shape, -1, jnp.int32),
             jnp.zeros(shape, jnp.float32), jnp.zeros(shape, jnp.float32))
    _, best_t, best_tri, best_u, best_v = jax.lax.while_loop(cond, body,
                                                             state)
    return best_t, best_tri, best_u, best_v


def trace_triangles(origin, direction, scene, t_min, t_max,
                    exclude_mesh=None, exclude_prim=None) -> HitRecord:
    """Nearest-hit trace of the wavefront against the world-space soup."""
    best_t, best_tri, best_u, best_v = trace_best(
        origin, direction, scene.triangles, scene.tri_bvh, scene.tri_kernel,
        t_min, t_max, exclude_mesh, exclude_prim)
    return _hit_record_from_best(origin, direction, scene.triangles,
                                 best_t, best_tri, best_u, best_v)


def _hit_record_from_best(origin, direction, tris, best_t, best_tri,
                          best_u, best_v) -> HitRecord:
    """Reconstruct the full hit record from (t, tri, u, v) via gathers."""
    shape = origin.shape[:-1]
    hit = best_tri >= 0
    tri = jnp.maximum(best_tri, 0)
    point = origin + best_t[..., None] * direction

    if tris.shade_packed is not None:
        # one (T,24) row gather instead of 8 narrow per-attribute gathers
        row = tris.shade_packed[tri]
        v0, v1, v2 = row[..., 0:3], row[..., 3:6], row[..., 6:9]
        n0c, n1c, n2c = row[..., 9:12], row[..., 12:15], row[..., 15:18]
        material = row[..., 18].astype(jnp.int32)
        mesh_index = row[..., 19].astype(jnp.int32)
    else:
        v0 = tris.v0[tri]
        v1 = tris.v1[tri]
        v2 = tris.v2[tri]
        n0c, n1c, n2c = tris.n0[tri], tris.n1[tri], tris.n2[tri]
        material = tris.material[tri]
        mesh_index = tris.mesh_index[tri]
    geo_n = safe_normalize(jnp.cross(v1 - v0, v2 - v0))
    front = dot(direction, geo_n) < 0.0
    n_faced = where3(front, geo_n, -geo_n)

    # Interpolate shading normal from per-corner normals using saturated
    # barycentric weights; flip toward the geometric normal
    # (reference: pathtrace.metal interpolate_shading_normal:597-700,
    # barycentric_weights_saturated:584-592, integrator flip :5895-5906).
    w = jnp.stack([1.0 - best_u - best_v, best_u, best_v], -1)
    w = jnp.maximum(w, 0.0)
    w_sum = jnp.sum(w, -1, keepdims=True)
    w = jnp.where(w_sum > 1e-8, w / w_sum,
                  jnp.asarray([1.0, 0.0, 0.0], jnp.float32))
    sn = (w[..., 0:1] * n0c + w[..., 1:2] * n1c + w[..., 2:3] * n2c)
    sn_ok = jnp.all(jnp.isfinite(sn), -1) & (dot(sn, sn) > 0.0)
    sn = jnp.where((dot(sn, n_faced) < 0.0)[..., None], -sn, sn)
    sn = safe_normalize(sn)
    shading_n = where3(sn_ok, sn, n_faced)

    return HitRecord(
        hit=hit,
        t=jnp.where(hit, best_t, INFINITY_T),
        point=point,
        normal=n_faced,
        shading_normal=shading_n,
        front_face=front,
        two_sided=jnp.zeros(shape, bool),
        material=material,
        prim_type=jnp.where(hit, PRIMITIVE_TRIANGLE, 0).astype(jnp.int32),
        prim_index=tri.astype(jnp.int32),
        mesh_index=mesh_index,
        barycentric=jnp.stack([best_u, best_v], -1),
    )


def mat3_apply(m33, x):
    """x @ m33.T for (..., 3) vectors, as elementwise sums in full float32
    (a dot would run in TF32 on tensor-core GPUs)."""
    return (x[..., 0:1] * m33[:, 0] + x[..., 1:2] * m33[:, 1]
            + x[..., 2:3] * m33[:, 2])


def _transform_point(m34, p):
    """(N,3) point through a per-lane-constant (3,4) affine row matrix."""
    return mat3_apply(m34[:, :3], p) + m34[:, 3]


def _transform_dir(m34, d):
    return mat3_apply(m34[:, :3], d)


def trace_instanced(origin, direction, scene, t_min, t_max,
                    exclude_mesh=None, exclude_prim=None) -> HitRecord:
    """Nearest hit over the scene's instanced mesh groups.

    Each group is one shared OBJECT-space BLAS traced once per instance
    with the ray affinely mapped into object space. The direction is
    mapped by the linear part WITHOUT renormalizing, so the hit parameter
    t is identical in both spaces and directly comparable across
    instances and the world-space soup (reference:
    SceneAccel.mm:173-247 SoftwareInstanceInfo worldToLocal +
    pathtrace.metal trace_scene_tlas_triangles:2167-2384).

    rec.mesh_index is the GLOBAL instance id (group.base_id + i), which
    keeps (mesh, prim) self-hit exclusion exact across instances.
    """
    shape = origin.shape[:-1]
    best = HitRecord.miss(shape)
    best = best.replace(t=jnp.broadcast_to(jnp.asarray(t_max, jnp.float32),
                                           shape))
    if exclude_mesh is None:
        exclude_mesh = jnp.full(shape, -1, jnp.int32)
    if exclude_prim is None:
        exclude_prim = jnp.full(shape, -1, jnp.int32)

    for group in scene.instanced:
        for i in range(group.count):
            inst_id = group.base_id + i
            o_l = _transform_point(group.w2l[i], origin)
            d_l = _transform_dir(group.w2l[i], direction)
            # exclusion only applies when the previous hit was THIS
            # instance (object tri ids repeat across instances)
            ex_p = jnp.where(exclude_mesh == inst_id, exclude_prim, -1)
            rec = _trace_group(group, i, o_l, d_l, origin, direction,
                               t_min, best.t, ex_p)
            best = _closer_rec(best, rec)
    # lanes that never hit keep the miss record
    return best.replace(t=jnp.where(best.hit, best.t, INFINITY_T))


def _closer_rec(a: HitRecord, b: HitRecord) -> HitRecord:
    from metal_pathtracer.ops.intersect import _closer
    return _closer(a, b)


def _trace_group(group, i, o_l, d_l, o_w, d_w, t_min, t_max,
                 exclude_prim) -> HitRecord:
    shape = o_l.shape[:-1]
    # a group's object-space soup is one mesh (mesh index 0)
    best_t, best_tri, bu, bv = trace_best(
        o_l, d_l, group.triangles, group.tri_bvh, group.tri_kernel,
        t_min, t_max, jnp.zeros(shape, jnp.int32), exclude_prim)

    # Reconstruct the record in WORLD space: attributes interpolate in
    # object space, normals map by the inverse-transpose linear part.
    tris = group.triangles
    hit = best_tri >= 0
    tri = jnp.maximum(best_tri, 0)
    row = tris.shade_packed[tri]
    v0, v1, v2 = row[..., 0:3], row[..., 3:6], row[..., 6:9]
    n0c, n1c, n2c = row[..., 9:12], row[..., 12:15], row[..., 15:18]

    nmat = group.nrm_mat[i]
    geo_l = jnp.cross(v1 - v0, v2 - v0)
    geo_w = safe_normalize(mat3_apply(nmat, geo_l))
    front = dot(d_w, geo_w) < 0.0
    n_faced = where3(front, geo_w, -geo_w)

    w0 = jnp.maximum(1.0 - bu - bv, 0.0)
    w1 = jnp.maximum(bu, 0.0)
    w2 = jnp.maximum(bv, 0.0)
    w_sum = jnp.maximum(w0 + w1 + w2, 1e-8)
    sn_l = (w0[..., None] * n0c + w1[..., None] * n1c
            + w2[..., None] * n2c) / w_sum[..., None]
    sn_w = mat3_apply(nmat, sn_l)
    sn_ok = jnp.all(jnp.isfinite(sn_w), -1) & (dot(sn_w, sn_w) > 0.0)
    sn_w = jnp.where((dot(sn_w, n_faced) < 0.0)[..., None], -sn_w, sn_w)
    sn_w = safe_normalize(sn_w)
    shading_n = where3(sn_ok, sn_w, n_faced)

    material = group.material[i]
    point = o_w + best_t[..., None] * d_w
    shape = o_w.shape[:-1]
    return HitRecord(
        hit=hit,
        t=jnp.where(hit, best_t, INFINITY_T),
        point=point,
        normal=n_faced,
        shading_normal=shading_n,
        front_face=front,
        two_sided=jnp.zeros(shape, bool),
        material=jnp.broadcast_to(material, shape).astype(jnp.int32),
        prim_type=jnp.where(hit, PRIMITIVE_TRIANGLE, 0).astype(jnp.int32),
        prim_index=tri.astype(jnp.int32),
        mesh_index=jnp.full(shape, group.base_id + i, jnp.int32),
        barycentric=jnp.stack([bu, bv], -1),
    )


def trace_occluded_triangles(origin, direction, scene, t_min, t_max):
    """Any-hit over the world-space soup (kernel route only)."""
    _, tri, _, _ = trace_best(origin, direction, scene.triangles,
                              scene.tri_bvh, scene.tri_kernel, t_min, t_max,
                              any_hit=True)
    return tri >= 0


def trace_instanced_occluded(origin, direction, scene, t_min, t_max):
    """Any-hit over the instanced groups (shadow rays)."""
    shape = origin.shape[:-1]
    occluded = jnp.zeros(shape, bool)
    for group in scene.instanced:
        for i in range(group.count):
            o_l = _transform_point(group.w2l[i], origin)
            d_l = _transform_dir(group.w2l[i], direction)
            # already-occluded lanes trace with tmax=0 (an empty window)
            lane_tmax = jnp.where(occluded, 0.0,
                                  jnp.broadcast_to(
                                      jnp.asarray(t_max, jnp.float32),
                                      shape))
            _, tri, _, _ = trace_best(o_l, d_l, group.triangles,
                                      group.tri_bvh, group.tri_kernel,
                                      t_min, lane_tmax, any_hit=True)
            occluded = occluded | (tri >= 0)
    return occluded
