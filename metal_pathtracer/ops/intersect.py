"""Analytic primitive intersection and scene tracing, fully vectorized.

The reference traces one ray per GPU thread through sequential primitive
loops and BVH stacks (reference: shaders/pathtrace.metal:1222-2384). Here a
whole wavefront of rays is intersected at once: primitive loops become
broadcast (lanes x prims) tests reduced with argmin, which XLA fuses into
one kernel, and BVH traversal (ops/traversal.py) handles triangle meshes.

Hit records are an SoA pytree (the reference's HitRecord,
pathtrace.metal:242-256).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from metal_pathtracer.constants import (
    INFINITY_T,
    PRIMITIVE_NONE,
    PRIMITIVE_RECTANGLE,
    PRIMITIVE_SPHERE,
)
from metal_pathtracer.ops.vecmath import dot, where3
from metal_pathtracer.utils import pytree

Array = jax.Array


@pytree.dataclass
class HitRecord:
    """SoA hit record over the wavefront (reference: pathtrace.metal:242-256)."""

    hit: Array            # (N,)  bool
    t: Array              # (N,)  f32
    point: Array          # (N,3) f32
    normal: Array         # (N,3) f32 — geometric, faceted toward the ray
    shading_normal: Array  # (N,3) f32
    front_face: Array     # (N,)  bool
    two_sided: Array      # (N,)  bool
    material: Array       # (N,)  i32
    prim_type: Array      # (N,)  i32
    prim_index: Array     # (N,)  i32
    mesh_index: Array     # (N,)  i32
    barycentric: Array    # (N,2) f32

    @classmethod
    def miss(cls, shape):
        z3 = jnp.zeros(shape + (3,), jnp.float32)
        zi = jnp.zeros(shape, jnp.int32)
        return cls(
            hit=jnp.zeros(shape, bool),
            t=jnp.full(shape, INFINITY_T, jnp.float32),
            point=z3,
            normal=z3,
            shading_normal=z3,
            front_face=jnp.zeros(shape, bool),
            two_sided=jnp.zeros(shape, bool),
            material=zi,
            prim_type=jnp.full(shape, PRIMITIVE_NONE, jnp.int32),
            prim_index=zi,
            mesh_index=zi,
            barycentric=jnp.zeros(shape + (2,), jnp.float32),
        )


def _closer(a: HitRecord, b: HitRecord) -> HitRecord:
    """Merge two hit sets, keeping the nearer hit per lane."""
    take_b = jnp.logical_and(b.hit, jnp.logical_or(jnp.logical_not(a.hit), b.t < a.t))
    sel = lambda x, y: jnp.where(take_b, y, x)
    sel3 = lambda x, y: where3(take_b, y, x)
    return HitRecord(
        hit=jnp.logical_or(a.hit, b.hit),
        t=sel(a.t, b.t),
        point=sel3(a.point, b.point),
        normal=sel3(a.normal, b.normal),
        shading_normal=sel3(a.shading_normal, b.shading_normal),
        front_face=sel(a.front_face, b.front_face),
        two_sided=sel(a.two_sided, b.two_sided),
        material=sel(a.material, b.material),
        prim_type=sel(a.prim_type, b.prim_type),
        prim_index=sel(a.prim_index, b.prim_index),
        mesh_index=sel(a.mesh_index, b.mesh_index),
        barycentric=jnp.where(take_b[..., None], b.barycentric, a.barycentric),
    )


def hit_spheres(origin, direction, spheres, t_min, t_max) -> HitRecord:
    """All-pairs sphere test + nearest reduction.

    Quadratic with half-b and near-then-far root selection per sphere
    (reference: pathtrace.metal hit_sphere:1239-1279). `direction` may be
    unnormalized — t is measured in units of |direction| exactly like the
    reference.
    """
    shape = origin.shape[:-1]
    if spheres is None or spheres.count == 0:
        return HitRecord.miss(shape)

    center = spheres.center           # (S,3)
    radius = spheres.radius           # (S,)
    oc = origin[..., None, :] - center  # (N,S,3)
    a = dot(direction, direction)[..., None]             # (N,1)
    half_b = jnp.sum(oc * direction[..., None, :], -1)   # (N,S)
    c = jnp.sum(oc * oc, -1) - radius * radius           # (N,S)

    disc = half_b * half_b - a * c
    sqrt_d = jnp.sqrt(jnp.maximum(disc, 0.0))
    t_near = (-half_b - sqrt_d) / a
    t_far = (-half_b + sqrt_d) / a
    tmin = t_min[..., None] if jnp.ndim(t_min) else t_min
    tmax = t_max[..., None] if jnp.ndim(t_max) else t_max
    near_ok = jnp.logical_and(t_near >= tmin, t_near <= tmax)
    far_ok = jnp.logical_and(t_far >= tmin, t_far <= tmax)
    t_cand = jnp.where(near_ok, t_near, t_far)
    valid = jnp.logical_and(disc >= 0.0, jnp.logical_or(near_ok, far_ok))

    t_masked = jnp.where(valid, t_cand, INFINITY_T)
    best = jnp.argmin(t_masked, axis=-1)                 # (N,)
    any_hit = jnp.any(valid, axis=-1)
    t_best = jnp.take_along_axis(t_masked, best[..., None], axis=-1)[..., 0]

    point = origin + t_best[..., None] * direction
    c_best = center[best]
    r_best = radius[best]
    outward = (point - c_best) / r_best[..., None]
    front = dot(direction, outward) < 0.0
    normal = where3(front, outward, -outward)

    return HitRecord(
        hit=any_hit,
        t=jnp.where(any_hit, t_best, INFINITY_T),
        point=point,
        normal=normal,
        shading_normal=normal,
        front_face=front,
        two_sided=jnp.ones(shape, bool),
        material=spheres.material[best],
        prim_type=jnp.full(shape, PRIMITIVE_SPHERE, jnp.int32),
        prim_index=best.astype(jnp.int32),
        mesh_index=jnp.zeros(shape, jnp.int32),
        barycentric=jnp.zeros(shape + (2,), jnp.float32),
    )


def hit_rects(origin, direction, rects, t_min, t_max) -> HitRecord:
    """Oriented-rectangle plane test (reference: pathtrace.metal:1280-1319)."""
    shape = origin.shape[:-1]
    if rects is None or rects.count == 0:
        return HitRecord.miss(shape)

    normal = rects.normal                                # (R,3)
    denom = jnp.sum(direction[..., None, :] * normal, -1)  # (N,R)
    t = (rects.plane - jnp.sum(origin[..., None, :] * normal, -1)) / denom
    point = origin[..., None, :] + t[..., None] * direction[..., None, :]
    rel = point - rects.corner
    u = jnp.sum(rel * rects.edge_u, -1) * rects.inv_len2_u
    v = jnp.sum(rel * rects.edge_v, -1) * rects.inv_len2_v

    tmin = t_min[..., None] if jnp.ndim(t_min) else t_min
    tmax = t_max[..., None] if jnp.ndim(t_max) else t_max
    valid = (jnp.abs(denom) >= 1e-6) & (t >= tmin) & (t <= tmax) \
        & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (v <= 1.0)

    t_masked = jnp.where(valid, t, INFINITY_T)
    best = jnp.argmin(t_masked, axis=-1)
    any_hit = jnp.any(valid, axis=-1)
    t_best = jnp.take_along_axis(t_masked, best[..., None], axis=-1)[..., 0]

    hit_point = origin + t_best[..., None] * direction
    n_best = normal[best]
    front = dot(direction, n_best) < 0.0
    n_faced = where3(front, n_best, -n_best)

    return HitRecord(
        hit=any_hit,
        t=jnp.where(any_hit, t_best, INFINITY_T),
        point=hit_point,
        normal=n_faced,
        shading_normal=n_faced,
        front_face=front,
        two_sided=rects.two_sided[best] > 0.5,
        material=rects.material[best],
        prim_type=jnp.full(shape, PRIMITIVE_RECTANGLE, jnp.int32),
        prim_index=best.astype(jnp.int32),
        mesh_index=jnp.zeros(shape, jnp.int32),
        barycentric=jnp.zeros(shape + (2,), jnp.float32),
    )


def trace_scene(origin, direction, scene, t_min, t_max,
                exclude_mesh=None, exclude_prim=None) -> HitRecord:
    """Nearest-hit trace over every primitive family present in the scene.

    The wavefront analogue of trace_scene_software(_with_exclusion)
    (reference: pathtrace.metal:2266-2384, 2796+). Triangle exclusion (self-
    hit avoidance by mesh/prim id) applies only to triangles, matching
    compute_exclusion_indices (reference: pathtrace.metal:258-269).
    """
    rec = hit_spheres(origin, direction, scene.spheres, t_min, t_max)
    rec = _closer(rec, hit_rects(origin, direction, scene.rects, t_min, t_max))
    if scene.triangles is not None and scene.triangles.count > 0:
        from metal_pathtracer.ops import traversal
        tri_rec = traversal.trace_triangles(
            origin, direction, scene, t_min, t_max,
            exclude_mesh=exclude_mesh, exclude_prim=exclude_prim)
        rec = _closer(rec, tri_rec)
    if scene.instanced:
        from metal_pathtracer.ops import traversal
        inst_rec = traversal.trace_instanced(
            origin, direction, scene, t_min, t_max,
            exclude_mesh=exclude_mesh, exclude_prim=exclude_prim)
        rec = _closer(rec, inst_rec)
    return rec


def trace_occluded(origin, direction, scene, t_min, t_max) -> Array:
    """Boolean any-hit (shadow) trace — semantics of anyHitOnly=true
    (reference: pathtrace.metal shadow rays + shadow-early-exit stats).

    On the kernel route the triangle part ends each lane on its first hit;
    the XLA route answers with the closest-hit search.
    """
    if scene.tri_kernel is None and not any(
            g.tri_kernel is not None for g in scene.instanced):
        return trace_scene(origin, direction, scene, t_min, t_max).hit
    from metal_pathtracer.ops import traversal
    occ = hit_spheres(origin, direction, scene.spheres, t_min, t_max).hit
    occ = occ | hit_rects(origin, direction, scene.rects, t_min, t_max).hit
    if scene.triangles is not None and scene.triangles.count > 0:
        occ = occ | traversal.trace_occluded_triangles(
            origin, direction, scene, t_min, t_max)
    if scene.instanced:
        occ = occ | traversal.trace_instanced_occluded(
            origin, direction, scene, t_min, t_max)
    return occ


def offset_ray_origin(rec: HitRecord, direction) -> Array:
    """Self-intersection-avoiding ray origin offset
    (reference: pathtrace.metal offset_ray_origin:1196-1207)."""
    from metal_pathtracer.constants import RAY_ORIGIN_EPSILON

    normal = rec.shading_normal
    bad = jnp.logical_or(
        jnp.logical_not(jnp.all(jnp.isfinite(normal), -1)),
        dot(normal, normal) <= 0.0)
    normal = where3(bad, rec.normal, normal)
    sign = jnp.where(dot(direction, normal) >= 0.0, 1.0, -1.0)
    distance = jnp.maximum(jnp.abs(rec.t) * 1e-4, RAY_ORIGIN_EPSILON)
    origin = rec.point + normal * (sign * distance)[..., None]
    return origin + direction * (RAY_ORIGIN_EPSILON * 0.5)
