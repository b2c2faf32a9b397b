"""Triangle mesh + BVH tests: builder invariants, traversal vs brute force,
loader round-trips, and an end-to-end mesh render."""

import os

import numpy as np
import pytest

from metal_pathtracer.scene import meshbuild
from metal_pathtracer.scene.resources import Mesh, SceneResources


def random_tris(n, seed=0, spread=10.0):
    rng = np.random.default_rng(seed)
    base = rng.uniform(-spread, spread, size=(n, 1, 3))
    verts = base + rng.uniform(-0.5, 0.5, size=(n, 3, 3))
    return verts[:, 0].astype(np.float32), verts[:, 1].astype(np.float32), \
        verts[:, 2].astype(np.float32)


def check_bvh_invariants(nodes, n_tris):
    n_nodes = len(nodes["prim_count"])
    assert (nodes["exit_index"] > np.arange(n_nodes)).all()
    assert nodes["exit_index"].max() == n_nodes
    # Every primitive appears exactly once across leaves
    leaf = nodes["prim_count"] > 0
    seen = []
    for off, cnt in zip(nodes["prim_offset"][leaf], nodes["prim_count"][leaf]):
        seen.extend(nodes["prim_indices"][off:off + cnt])
    assert sorted(seen) == list(range(n_tris))
    assert nodes["prim_count"].max() <= meshbuild.MAX_LEAF
    # Child bounds within parent's (internal node at i has child at i+1)
    internal = np.nonzero(~leaf)[0]
    for i in internal:
        child = i + 1
        assert (nodes["bounds_min"][child] >= nodes["bounds_min"][i] - 1e-5).all()
        assert (nodes["bounds_max"][child] <= nodes["bounds_max"][i] + 1e-5).all()


def test_numpy_builder_invariants():
    v0, v1, v2 = random_tris(257)
    nodes = meshbuild._build_bvh_numpy(v0, v1, v2)
    check_bvh_invariants(nodes, 257)


def test_native_builder_invariants():
    lib = meshbuild._native_lib()
    if lib is None:
        pytest.skip("native builder not built (run native/build.sh)")
    v0, v1, v2 = random_tris(513, seed=3)
    nodes = meshbuild._build_bvh_native(lib, v0, v1, v2)
    check_bvh_invariants(nodes, 513)


def _scene_with_tris(v0, v1, v2, builder="auto"):
    import jax.numpy as jnp
    from metal_pathtracer.schema import BvhSoA, SceneArrays, TrianglesSoA
    from metal_pathtracer.scene.resources import Material

    n = v0.shape[0]
    if builder == "numpy":
        nodes = meshbuild._build_bvh_numpy(v0, v1, v2)
    else:
        nodes = meshbuild.build_bvh(v0, v1, v2)
    j = jnp.asarray
    z3 = np.zeros((n, 3), np.float32)
    z2 = np.zeros((n, 2), np.float32)
    z4 = np.zeros((n, 4), np.float32)
    tris = TrianglesSoA(
        v0=j(v0), v1=j(v1), v2=j(v2),
        material=j(np.zeros(n, np.int32)), mesh_index=j(np.zeros(n, np.int32)),
        n0=j(z3), n1=j(z3), n2=j(z3),
        uv0=j(z2), uv1=j(z2), uv2=j(z2),
        uvb0=j(z2), uvb1=j(z2), uvb2=j(z2),
        t0=j(z4), t1=j(z4), t2=j(z4))
    bvh = BvhSoA(
        bounds_min=j(nodes["bounds_min"]), bounds_max=j(nodes["bounds_max"]),
        prim_offset=j(nodes["prim_offset"]), prim_count=j(nodes["prim_count"]),
        exit_index=j(nodes["exit_index"]), prim_indices=j(nodes["prim_indices"]))

    res = SceneResources()
    res.add_material(Material())
    scene = res.build_arrays()
    return scene.replace(triangles=tris, tri_bvh=bvh)


def brute_force_hits(origins, dirs, v0, v1, v2, t_min=1e-3, t_max=1e20):
    """Reference Möller–Trumbore in numpy."""
    e1 = (v1 - v0)[None]
    e2 = (v2 - v0)[None]
    d = dirs[:, None, :]
    p = np.cross(d, e2)
    det = (e1 * p).sum(-1)
    inv = np.where(np.abs(det) < 1e-8, np.nan, 1.0 / det)
    tv = origins[:, None, :] - v0[None]
    u = (tv * p).sum(-1) * inv
    q = np.cross(tv, e1)
    v = (d * q).sum(-1) * inv
    t = (e2 * q).sum(-1) * inv
    ok = (np.abs(det) >= 1e-8) & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) \
        & (t >= t_min) & (t <= t_max)
    t = np.where(ok, t, np.inf)
    best = t.min(1)
    tri = np.where(np.isfinite(best), t.argmin(1), -1)
    return best, tri


@pytest.mark.parametrize("builder", ["numpy", "auto"])
def test_traversal_matches_brute_force(builder):
    import jax.numpy as jnp
    from metal_pathtracer.ops import traversal

    v0, v1, v2 = random_tris(200, seed=11, spread=5.0)
    scene = _scene_with_tris(v0, v1, v2, builder)

    rng = np.random.default_rng(5)
    origins = rng.uniform(-20, 20, size=(256, 3)).astype(np.float32)
    dirs = rng.normal(size=(256, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)

    rec = traversal.trace_triangles(jnp.asarray(origins), jnp.asarray(dirs),
                                    scene, 1e-3, 1e20)
    want_t, want_tri = brute_force_hits(origins, dirs, v0, v1, v2)

    got_hit = np.asarray(rec.hit)
    want_hit = np.isfinite(want_t)
    np.testing.assert_array_equal(got_hit, want_hit)
    np.testing.assert_allclose(np.asarray(rec.t)[want_hit], want_t[want_hit],
                               rtol=1e-4)
    # same triangle modulo exact ties
    mismatch = (np.asarray(rec.prim_index)[want_hit] != want_tri[want_hit])
    assert mismatch.mean() < 0.01


def test_exclusion_skips_self():
    import jax.numpy as jnp
    from metal_pathtracer.ops import traversal

    # Two parallel triangles stacked in z; exclude the nearer one.
    v0 = np.array([[0, 0, 1], [0, 0, 2]], np.float32)
    v1 = np.array([[4, 0, 1], [4, 0, 2]], np.float32)
    v2 = np.array([[0, 4, 1], [0, 4, 2]], np.float32)
    scene = _scene_with_tris(v0, v1, v2)
    o = jnp.asarray([[1.0, 1.0, 0.0]], jnp.float32)
    d = jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32)
    rec = traversal.trace_triangles(o, d, scene, 1e-3, 1e20)
    assert int(np.asarray(rec.prim_index)[0]) == 0
    rec2 = traversal.trace_triangles(
        o, d, scene, 1e-3, 1e20,
        exclude_mesh=jnp.asarray([0], jnp.int32),
        exclude_prim=jnp.asarray([0], jnp.int32))
    assert int(np.asarray(rec2.prim_index)[0]) == 1


CUBE_OBJ = """\
v -1 -1 -1
v 1 -1 -1
v 1 1 -1
v -1 1 -1
v -1 -1 1
v 1 -1 1
v 1 1 1
v -1 1 1
f 1 2 3 4
f 8 7 6 5
f 1 5 6 2
f 2 6 7 3
f 3 7 8 4
f 5 1 4 8
"""


def test_obj_loader(tmp_path):
    from metal_pathtracer.scene.obj import load_obj
    p = tmp_path / "cube.obj"
    p.write_text(CUBE_OBJ)
    mesh = load_obj(str(p))
    assert mesh.indices.shape == (12, 3)   # 6 quads fan-triangulated
    assert mesh.vertices.shape == (8, 3)
    # Fallback flat normals were generated (quads share dedup'd vertices, so
    # later faces may inherit earlier faces' normals; all must be unit)
    assert (np.linalg.norm(mesh.normals, axis=-1) > 0.99).all()


def test_obj_loader_transform(tmp_path):
    from metal_pathtracer.scene.obj import load_obj
    p = tmp_path / "cube.obj"
    p.write_text(CUBE_OBJ)
    tf = np.eye(4)
    tf[:3, :3] *= 2.0
    tf[:3, 3] = (5, 0, 0)
    mesh = load_obj(str(p), transform=tf)
    assert mesh.vertices[:, 0].min() == pytest.approx(3.0)
    assert mesh.vertices[:, 0].max() == pytest.approx(7.0)


def test_ply_loader_ascii(tmp_path):
    from metal_pathtracer.scene.ply import load_ply
    ply = """\
ply
format ascii 1.0
element vertex 3
property float x
property float y
property float z
element face 1
property list uchar int vertex_indices
end_header
0 0 0
1 0 0
0 1 0
3 0 1 2
"""
    p = tmp_path / "tri.ply"
    p.write_text(ply)
    mesh = load_ply(str(p))
    assert mesh.indices.shape == (1, 3)
    np.testing.assert_allclose(mesh.normals[0], [0, 0, 1])


def test_ply_loader_binary(tmp_path):
    import struct
    from metal_pathtracer.scene.ply import load_ply
    header = (b"ply\nformat binary_little_endian 1.0\n"
              b"element vertex 3\n"
              b"property float x\nproperty float y\nproperty float z\n"
              b"element face 1\n"
              b"property list uchar int vertex_indices\n"
              b"end_header\n")
    body = b"".join(struct.pack("<fff", *v)
                    for v in [(0, 0, 0), (2, 0, 0), (0, 2, 0)])
    body += struct.pack("<B", 3) + struct.pack("<iii", 0, 1, 2)
    p = tmp_path / "tri.ply"
    p.write_bytes(header + body)
    mesh = load_ply(str(p))
    assert mesh.indices.shape == (1, 3)
    assert mesh.vertices[1, 0] == 2.0


def test_mesh_render_end_to_end(tmp_path):
    """A mesh quad acts like the rectangle it covers: render a scene where
    a big emissive-lit triangle floor is visible."""
    import jax.numpy as jnp
    from metal_pathtracer.ops.camera import build_camera
    from metal_pathtracer.renderer import frame
    from metal_pathtracer.renderer.accumulation import RenderState
    from metal_pathtracer.scene import dsl
    from metal_pathtracer.scene.meshload import mesh_loader
    from metal_pathtracer.schema import settings_to_static, settings_to_uniforms
    from metal_pathtracer.settings import RenderSettings

    obj = tmp_path / "quad.obj"
    obj.write_text("v -5 0 -5\nv 5 0 -5\nv 5 0 5\nv -5 0 5\nf 1 2 3 4\n")
    scene_text = f"""\
camera target=0,0,0 distance=4 yaw=0 pitch=0.5 vfov=45
renderer maxDepth=3 seed=7 width=24 height=24
background solid=0.5,0.6,0.9
material type=lambert albedo=0.9,0.2,0.2
mesh path={obj} material=0
"""
    settings = RenderSettings()
    res = SceneResources()
    dsl.parse_scene(scene_text, settings, res, scene_directory=str(tmp_path),
                    mesh_loader=mesh_loader)
    assert len(res.meshes) == 1
    scene = res.build_arrays()
    static = settings_to_static(settings, 24, 24, res.material_types_present())
    cam = build_camera(settings, 24, 24)
    uni = settings_to_uniforms(settings, cam, 0, 0)
    st = frame.render_samples(scene, uni, RenderState.create(24, 24), static, 2)
    img = np.asarray(st.present())
    assert np.isfinite(img).all()
    center = img[12, 12]
    # Looking down at a red floor: center pixel clearly red-dominant
    assert center[0] > center[2]
    assert center[0] > 0.05
