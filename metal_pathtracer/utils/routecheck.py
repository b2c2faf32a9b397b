"""Traversal kernel vs the plain-XLA traversal on the same rays.

Shared by chip_smoke.py, bench.py's selfcheck and the on-card tests: one
integrator chunk of camera rays plus one bounce generation, traced by the
kernel (closest and any hit) and by the XLA loop, and compared at the
tolerances below. The two routes run the same arithmetic, but each
compiler contracts multiply-adds into FMAs on its own, so on a GPU they
may differ in the last bits:

- hit flag and triangle id agree on >= 99.99% of lanes (AGREE_MIN), and
  every disagreement must be a near-tie. Where both routes hit, the two
  candidates' t differ by < 1e-6 relative (TIE_REL), a few float32 ulps,
  which is what an FMA-level difference can reorder. Where one route hits
  and the other misses, the hit lies on a triangle edge (a barycentric
  within EDGE_TOL of the boundary), where the same rounding can move a
  grazing ray across the edge;
- on agreeing lanes, t, u and v within 1e-5 relative (REL). Each is a dot
  product divided by the determinant, so FMA rounding moves it by a few
  ulps of the dot product's terms, not of the result: a grazing ray (small
  determinant) amplifies that. The error is therefore taken relative to
  max(|x|, |terms| / |det|) (the condition of the solve, and at least 1 for
  u and v); 1e-5 leaves an order of magnitude over ulp-level rounding
  while still catching a wrong formula;
- any-hit occlusion flags equal the kernel's closest-hit flags on every
  lane: a valid hit in the window exists or it does not, whichever is
  found first.
"""

from __future__ import annotations

import time

import numpy as np

AGREE_MIN = 0.9999
TIE_REL = 1e-6
REL = 1e-5
EDGE_TOL = 1e-5


def chunk_rays(settings, width: int, height: int, lanes: int,
               chunk_index: int | None = None):
    """Camera rays of one integrator chunk in the frame's tile order
    (frame._pixel_order); by default the chunk at the image centre."""
    import jax.numpy as jnp

    from metal_pathtracer.ops import camera as camera_ops
    from metal_pathtracer.ops import rng as rng_ops
    from metal_pathtracer.ops.camera import build_camera
    from metal_pathtracer.renderer.frame import _pixel_order
    from metal_pathtracer.schema import settings_to_uniforms

    x, y, _, _ = _pixel_order(height, width)
    n_chunks = max(len(x) // lanes, 1)
    k = n_chunks // 2 if chunk_index is None else chunk_index
    x = jnp.asarray(x[k * lanes:(k + 1) * lanes])
    y = jnp.asarray(y[k * lanes:(k + 1) * lanes])
    uni = settings_to_uniforms(settings, build_camera(settings, width,
                                                      height), 0, 0)
    seed = rng_ops.make_seed(uni.fixed_rng_seed, uni.frame_index, x, y,
                             uni.sample_count,
                             jnp.zeros(x.shape, jnp.uint32))
    _, origin, direction = camera_ops.generate_primary_rays(
        uni.camera, x, y, width, height, seed)
    return origin, direction


def bounce_rays(scene, origin, direction, seed: int = 0):
    """One diffuse bounce generation from the XLA route's primary hits:
    cosine-distributed directions about the shading normal, offset
    origins, self-hit exclusion, and empty windows for lanes that
    missed (as the integrator traces dead lanes)."""
    import jax.numpy as jnp

    from metal_pathtracer.constants import INFINITY_T
    from metal_pathtracer.ops import intersect

    rec = intersect.trace_scene(origin, direction, scene.replace(
        tri_kernel=None), 1e-4, INFINITY_T)
    n = origin.shape[0]
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    nrm = np.asarray(rec.shading_normal)
    d = d + nrm
    d /= np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-12)
    d = jnp.asarray(d)
    o2 = intersect.offset_ray_origin(rec, d)
    hit = rec.hit
    t_max = jnp.where(hit, INFINITY_T, 0.0)
    ex_mesh = jnp.where(hit, rec.mesh_index, -1)
    ex_prim = jnp.where(hit, rec.prim_index, -1)
    return o2, d, t_max, ex_mesh, ex_prim


def compare(scene, origin, direction, t_min, t_max, exclude_mesh=None,
            exclude_prim=None) -> dict:
    """Trace with both routes over the scene's world-space soup and
    measure agreement. Needs a scene built with the kernel route."""
    from metal_pathtracer.ops import traversal

    assert scene.tri_kernel is not None, "scene built without the kernel"
    args = (origin, direction, scene.triangles, scene.tri_bvh)
    win = (t_min, t_max, exclude_mesh, exclude_prim)
    kt, ktri, ku, kv = map(np.asarray, traversal.trace_best(
        *args, scene.tri_kernel, *win))
    xt, xtri, xu, xv = map(np.asarray, traversal.trace_best(
        *args, None, *win))
    _, atri, _, _ = traversal.trace_best(*args, scene.tri_kernel, *win,
                                         any_hit=True)
    atri = np.asarray(atri)

    khit, xhit = ktri >= 0, xtri >= 0
    agree = (khit == xhit) & (~khit | (ktri == xtri))
    both = khit & xhit & ~agree
    tie_rel = np.abs(kt - xt) / np.maximum(np.abs(xt), 1e-30)
    flip = khit != xhit
    fu, fv = np.where(khit, ku, xu), np.where(khit, kv, xv)
    edge = np.minimum(np.minimum(fu, fv), 1.0 - fu - fv) < EDGE_TOL
    same = agree & khit
    scale_t, scale_u, scale_v = _solve_scales(scene, origin, direction,
                                              np.maximum(xtri, 0))
    t_rel = np.abs(kt - xt) / np.maximum(np.abs(xt), scale_t)
    uv_err = np.maximum(
        np.abs(ku - xu) / np.maximum(1.0, scale_u),
        np.abs(kv - xv) / np.maximum(1.0, scale_v))
    out = {
        "lanes": int(len(ktri)),
        "hits": int(xhit.sum()),
        "agree_frac": float(agree.mean()),
        "disagree": int((~agree).sum()),
        "hit_flag_flips": int(flip.sum()),
        "flips_off_edge": int((flip & ~edge).sum()),
        "max_tie_rel": float(tie_rel[both].max(initial=0.0)),
        "max_t_rel": float(t_rel[same].max(initial=0.0)),
        "max_uv_rel": float(uv_err[same].max(initial=0.0)),
        "anyhit_mismatch": int(((atri >= 0) != khit).sum()),
    }
    out["ok"] = bool(
        out["agree_frac"] >= AGREE_MIN
        and out["flips_off_edge"] == 0
        and out["max_tie_rel"] < TIE_REL
        and out["max_t_rel"] <= REL
        and out["max_uv_rel"] <= REL
        and out["anyhit_mismatch"] == 0)
    return out


def _solve_scales(scene, origin, direction, tri):
    """|terms| / |det| of the t, u and v dot products of Möller–Trumbore
    for each lane's triangle (host numpy)."""
    tris = scene.triangles
    a, b, c = (np.asarray(x)[tri] for x in (tris.v0, tris.v1, tris.v2))
    o, d = np.asarray(origin), np.asarray(direction)
    n = lambda x: np.linalg.norm(x, axis=-1)
    e1, e2 = b - a, c - a
    p = np.cross(d, e2)
    s = o - a
    q = np.cross(s, e1)
    det = np.maximum(np.abs((e1 * p).sum(-1)), 1e-30)
    return n(e2) * n(q) / det, n(s) * n(p) / det, n(d) * n(q) / det


def time_call(fn, reps: int = 5) -> float:
    """Median wall seconds of fn() (which must block until the device is
    done), after one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))
