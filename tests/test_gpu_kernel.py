"""The traversal kernel compiled for the card, against the XLA route on the
card. Marked `gpu`: skipped without an NVIDIA GPU; chip_smoke.py runs them
on the card."""

import numpy as np
import pytest

pytestmark = pytest.mark.gpu


def _mesh_scene(route, subdivisions=5, instanced=False):
    from metal_pathtracer.scene.resources import Material, Mesh, \
        SceneResources
    from metal_pathtracer.utils.procgen import dragon_class_mesh

    res = SceneResources()
    res.add_material(Material())
    pos, normals, faces = dragon_class_mesh(subdivisions)
    uv = np.zeros((len(pos), 2), np.float32)
    mesh = Mesh(name="blob", vertices=pos, normals=normals, uv0=uv,
                uv1=uv.copy(), tangents=np.zeros((len(pos), 4), np.float32),
                indices=faces, material=0)
    if instanced:
        for tx in (-1.2, 1.2):
            m = np.eye(4)
            m[:3, :3] *= 0.8
            m[0, 3] = tx
            res.add_mesh_instance(mesh, m)
    else:
        res.add_mesh(mesh)
    return res.build_arrays(traversal=route)


def _rays(n, seed=3):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    target = rng.normal(scale=0.6, size=(n, 3)).astype(np.float32)
    d = np.where(np.arange(n)[:, None] % 4 == 0,
                 rng.normal(size=(n, 3)), target - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


@pytest.mark.parametrize("block", [64, 128, 256])
def test_kernel_matches_xla_on_card(gpu_device, block):
    from metal_pathtracer.utils import routecheck

    scene = _mesh_scene("kernel")
    scene = scene.replace(tri_kernel=scene.tri_kernel.replace(block=block))
    n = 65536 + 37  # not a multiple of any block
    o, d = _rays(n)
    tmax = np.where(np.arange(n) % 7 == 0, 1.5, 1e30).astype(np.float32)
    r = routecheck.compare(scene, o, d, 1e-3, tmax)
    assert r["ok"], r


def test_instanced_occlusion_on_card(gpu_device):
    import jax.numpy as jnp

    from metal_pathtracer.ops import intersect

    kern = _mesh_scene("kernel", 4, instanced=True)
    xla = _mesh_scene("xla", 4, instanced=True)
    o, d = map(jnp.asarray, _rays(16384, seed=5))
    occ_k = np.asarray(intersect.trace_occluded(o, d, kern, 1e-3, 1e30))
    occ_x = np.asarray(intersect.trace_occluded(o, d, xla, 1e-3, 1e30))
    hit_x = np.asarray(intersect.trace_scene(o, d, xla, 1e-3, 1e30).hit)
    np.testing.assert_array_equal(occ_x, hit_x)
    assert (occ_k != occ_x).sum() <= 2  # edge-grazing rounding only


def test_render_kernel_route_matches_xla_route_on_card(gpu_device):
    from metal_pathtracer.renderer.headless import JaxBackend
    from metal_pathtracer.utils.benchscene import build_bench_scene

    settings, res, env = build_bench_scene(3)
    settings.maxDepth = 4
    imgs = {route: JaxBackend(route).render(res, settings, 48, 32, 4,
                                           environment=env).linear_rgb
            for route in ("kernel", "xla")}
    d = imgs["kernel"] - imgs["xla"]
    assert np.isfinite(imgs["kernel"]).all()
    assert float(np.sqrt((d * d).mean())) < 1e-3
