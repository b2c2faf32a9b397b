"""The traversal kernel (ops/pallas/traverse.py) under the Pallas
interpreter, against NumPy brute-force Möller–Trumbore.

Parametrised over closest and any hit, two block sizes, and the cases the
kernel has to get right: lane counts that are not a multiple of the block,
self-hit exclusion, per-lane t_max, all-miss wavefronts, degenerate
triangles, and instanced groups traced in object space.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest

from metal_pathtracer.ops import traversal
from metal_pathtracer.scene import meshbuild
from metal_pathtracer.scene.resources import Material, Mesh, SceneResources


def _soup(n, seed, spread=4.0, degenerate=0):
    rng = np.random.default_rng(seed)
    base = rng.uniform(-spread, spread, size=(n, 1, 3))
    verts = (base + rng.uniform(-0.8, 0.8, size=(n, 3, 3))).astype(np.float32)
    if degenerate:
        # zero-area triangles: collapsed to a point or to a segment
        verts[:degenerate // 2, 1] = verts[:degenerate // 2, 0]
        verts[:degenerate // 2, 2] = verts[:degenerate // 2, 0]
        seg = slice(degenerate // 2, degenerate)
        verts[seg, 2] = 0.5 * (verts[seg, 0] + verts[seg, 1])
    return verts[:, 0], verts[:, 1], verts[:, 2]


def _mesh(v0, v1, v2, material=0):
    n = len(v0)
    v = np.stack([v0, v1, v2], 1).reshape(-1, 3).astype(np.float32)
    nrm = np.tile(np.array([[0, 1, 0]], np.float32), (len(v), 1))
    uv = np.zeros((len(v), 2), np.float32)
    return Mesh(name="soup", vertices=v, normals=nrm, uv0=uv, uv1=uv.copy(),
                tangents=np.zeros((len(v), 4), np.float32),
                indices=np.arange(3 * n, dtype=np.int32).reshape(-1, 3),
                material=material)


def _scene(v0, v1, v2, block):
    res = SceneResources()
    res.add_material(Material())
    res.add_mesh(_mesh(v0, v1, v2))
    scene = res.build_arrays(traversal="interpret")
    return scene.replace(tri_kernel=scene.tri_kernel.replace(block=block))


def _brute(o, d, v0, v1, v2, t_min, t_max, ex_prim=None):
    e1, e2 = (v1 - v0)[None], (v2 - v0)[None]
    dd = d[:, None, :]
    p = np.cross(dd, e2)
    det = (e1 * p).sum(-1)
    inv = np.where(np.abs(det) < 1e-8, np.nan, 1.0 / det)
    s = o[:, None, :] - v0[None]
    u = (s * p).sum(-1) * inv
    q = np.cross(s, e1)
    v = (dd * q).sum(-1) * inv
    t = (e2 * q).sum(-1) * inv
    ok = (np.abs(det) >= 1e-8) & (u >= 0) & (u <= 1) & (v >= 0) \
        & (u + v <= 1) & (t >= t_min) & (t <= t_max[:, None])
    if ex_prim is not None:
        ok &= np.arange(len(v0))[None] != ex_prim[:, None]
    t = np.where(ok, t, np.inf)
    best = t.min(1)
    return best, np.where(np.isfinite(best), t.argmin(1), -1)


def _rays(n, seed, aim=True):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-7, 7, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    if aim:  # most rays aimed into the soup so traversal goes deep
        half = n // 2
        d[:half] = rng.uniform(-3, 3, (half, 3)) - o[:half]
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _check(scene, o, d, t_min, t_max, v0, v1, v2, any_hit, ex_prim=None):
    n = len(o)
    t, tri, u, v = map(np.asarray, traversal.trace_best(
        jnp.asarray(o), jnp.asarray(d), scene.triangles, scene.tri_bvh,
        scene.tri_kernel, t_min, jnp.asarray(t_max),
        None if ex_prim is None else jnp.zeros(n, jnp.int32),
        None if ex_prim is None else jnp.asarray(ex_prim),
        any_hit=any_hit))
    want_t, want_tri = _brute(o, d, v0, v1, v2, t_min, t_max, ex_prim)
    hit = np.isfinite(want_t)
    np.testing.assert_array_equal(tri >= 0, hit)
    if not hit.any():
        return hit
    if any_hit:
        # the first hit found: a real hit of that lane, inside the window
        assert (t[hit] >= t_min).all() and (t[hit] <= t_max[hit]).all()
        assert (t[hit] >= want_t[hit] * (1 - 1e-5)).all()
    else:
        np.testing.assert_allclose(t[hit], want_t[hit], rtol=1e-4)
        assert (tri[hit] != want_tri[hit]).mean() < 0.01   # exact ties
        assert ((u[hit] >= -1e-6) & (v[hit] >= -1e-6)
                & (u[hit] + v[hit] <= 1 + 1e-5)).all()
    return hit


CASES = ["ragged_lanes", "exclusion", "lane_tmax", "all_miss",
         "degenerate"]


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("block", [64, 128])
@pytest.mark.parametrize("case", CASES)
def test_kernel_matches_brute_force(case, block, any_hit):
    v0, v1, v2 = _soup(150, seed=11,
                       degenerate=40 if case == "degenerate" else 0)
    scene = _scene(v0, v1, v2, block)
    n = 200 if case == "ragged_lanes" else 3 * block
    o, d = _rays(n, seed=5)
    t_max = np.full(n, 1e20, np.float32)
    ex_prim = None
    if case == "exclusion":
        # exclude each lane's own closest hit: the answer is the next one
        _, first = _brute(o, d, v0, v1, v2, 1e-3, t_max)
        ex_prim = first.astype(np.int32)
    elif case == "lane_tmax":
        t_max = np.random.default_rng(3).choice(
            [0.0, 0.5, 2.0, 6.0, 1e20], n).astype(np.float32)
    elif case == "all_miss":
        o = o + np.float32(100.0)
        d = np.abs(d)  # pointing away from the soup
    hit = _check(scene, o, d, 1e-3, t_max, v0, v1, v2, any_hit, ex_prim)
    if case == "all_miss":
        assert not hit.any()
    else:
        assert 0 < hit.sum() < n


def _instanced_scene(route, block=64):
    rng = np.random.default_rng(7)
    v0, v1, v2 = _soup(40, seed=2, spread=1.0)
    res = SceneResources()
    res.add_material(Material())
    src = _mesh(v0, v1, v2)
    for k in range(3):
        ry = float(rng.uniform(0, math.pi))
        c, s = math.cos(ry), math.sin(ry)
        m = np.eye(4)
        m[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]]) \
            * (0.6 + 0.3 * k)
        m[:3, 3] = rng.uniform(-3, 3, 3)
        res.add_mesh_instance(src, m)
    res.add_mesh(_mesh(*_soup(30, seed=9)))
    scene = res.build_arrays(traversal=route)
    if route == "interpret":
        scene = scene.replace(
            tri_kernel=scene.tri_kernel.replace(block=block),
            instanced=tuple(g.replace(tri_kernel=g.tri_kernel.replace(
                block=block)) for g in scene.instanced))
    return scene


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("block", [64, 128])
def test_kernel_instanced_object_space(block, any_hit):
    """Instanced groups trace the kernel in object space; the world-space
    record (and the occlusion flag) must equal the XLA route's."""
    from metal_pathtracer.ops import intersect

    kern = _instanced_scene("interpret", block)
    xla = _instanced_scene("xla")
    o, d = map(jnp.asarray, _rays(300, seed=8))
    if any_hit:
        got = intersect.trace_occluded(o, d, kern, 1e-3, 1e20)
        want = intersect.trace_occluded(o, d, xla, 1e-3, 1e20)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        assert np.asarray(want).any()
        return
    a = intersect.trace_scene(o, d, kern, 1e-3, 1e20)
    b = intersect.trace_scene(o, d, xla, 1e-3, 1e20)
    np.testing.assert_array_equal(np.asarray(a.hit), np.asarray(b.hit))
    h = np.asarray(b.hit)
    assert h.any()
    for f in ("prim_index", "mesh_index", "material"):
        np.testing.assert_array_equal(np.asarray(getattr(a, f))[h],
                                      np.asarray(getattr(b, f))[h])
    np.testing.assert_allclose(np.asarray(a.t)[h], np.asarray(b.t)[h],
                               rtol=1e-5)
    np.testing.assert_allclose(np.asarray(a.normal)[h],
                               np.asarray(b.normal)[h], atol=1e-4)


def test_pack_tables_layout():
    """Node rows carry the BVH's bounds, exit links and leaf ranges
    bit-exactly; triangle rows are the leaf-order soup."""
    from metal_pathtracer.ops.pallas import traverse

    v0, v1, v2 = _soup(100, seed=4)
    nodes = meshbuild.build_bvh(v0, v1, v2)
    mesh_index = np.arange(100, dtype=np.int32) % 3
    node_rows, tri_rows = traverse.pack_tables(nodes, v0, v1, v2, mesh_index)
    f = lambda a: a.view(np.float32)
    np.testing.assert_array_equal(f(node_rows[:, 0:3]), nodes["bounds_min"])
    np.testing.assert_array_equal(f(node_rows[:, 3:6]), nodes["bounds_max"])
    np.testing.assert_array_equal(node_rows[:, 6], nodes["exit_index"])
    count = node_rows[:, 7] & traverse.LEAF_MASK
    offset = node_rows[:, 7] >> traverse.LEAF_SHIFT
    np.testing.assert_array_equal(count, nodes["prim_count"])
    leaf = count > 0
    np.testing.assert_array_equal(offset[leaf], nodes["prim_offset"][leaf])
    ids = nodes["prim_indices"]
    np.testing.assert_array_equal(tri_rows[:, 9], ids)
    np.testing.assert_array_equal(tri_rows[:, 10], mesh_index[ids])
    np.testing.assert_array_equal(f(tri_rows[:, 0:3]), v0[ids])
    np.testing.assert_array_equal(f(tri_rows[:, 6:9]), v2[ids])
