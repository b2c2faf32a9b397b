"""Igehy first-hit UV gradients vs finite differences
(reference: pathtrace.metal:203-257)."""

import numpy as np
import jax.numpy as jnp

from metal_pathtracer.ops import intersect
from metal_pathtracer.ops.camera import build_camera
from metal_pathtracer.ops.pbr_textures import _igehy_uv_gradient
from metal_pathtracer.scene.resources import Material, SceneResources
from metal_pathtracer.schema import settings_to_static, settings_to_uniforms
from metal_pathtracer.settings import RenderSettings


def _quad_scene():
    res = SceneResources()
    res.add_material(Material(base_color=(0.5, 0.5, 0.5)))
    from metal_pathtracer.scene.resources import Mesh
    # unit quad at z=-1, facing +z, uv spanning [0,1]^2
    v = np.array([[-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1]],
                 np.float32)
    n = np.tile(np.array([[0, 0, 1]], np.float32), (4, 1))
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    f = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    res.add_mesh(Mesh(name="quad", vertices=v, normals=n, uv0=uv,
                      uv1=uv.copy(), tangents=np.zeros((4, 4), np.float32),
                      indices=f, material=0))
    return res.build_arrays()


def _pixel_ray(cam, x, y, W, H):
    u = (x + 0.5) / W
    v = 1.0 - (y + 0.5) / H
    pix = np.asarray(cam.lower_left) + u * np.asarray(cam.horizontal) \
        + v * np.asarray(cam.vertical)
    o = np.asarray(cam.origin)
    return o, pix - o


def _uv_at(scene, o, d):
    rec = intersect.trace_scene(jnp.asarray(o[None]), jnp.asarray(d[None]),
                                scene, 1e-3, 3e38)
    assert bool(np.asarray(rec.hit)[0])
    bary = np.asarray(rec.barycentric)[0]
    tri = int(np.asarray(rec.prim_index)[0])
    tris = scene.triangles
    w0 = 1.0 - bary[0] - bary[1]
    uv = (w0 * np.asarray(tris.uv0)[tri] + bary[0] * np.asarray(tris.uv1)[tri]
          + bary[1] * np.asarray(tris.uv2)[tri])
    return uv, rec, tri


def test_igehy_gradient_matches_finite_difference():
    W, H = 64, 48
    settings = RenderSettings()
    settings.cameraTarget = (0.0, 0.0, -1.0)
    settings.cameraDistance = 2.0
    settings.cameraYaw = 0.3
    settings.cameraPitch = 0.2
    settings.cameraVerticalFov = 45.0
    scene = _quad_scene()
    static = settings_to_static(settings, W, H, (0,))
    cam = build_camera(settings, W, H)
    uniforms = settings_to_uniforms(settings, cam, 0, 0)

    for (px, py) in ((32, 24), (28, 20), (36, 26)):
        o, d = _pixel_ray(cam, px, py, W, H)
        uv_c, rec, tri = _uv_at(scene, o, d)
        _, dx_d = _pixel_ray(cam, px + 1, py, W, H)
        uv_x, _, _ = _uv_at(scene, o, dx_d)
        _, dy_d = _pixel_ray(cam, px, py + 1, W, H)
        uv_y, _, _ = _uv_at(scene, o, dy_d)
        fd = max(np.linalg.norm(uv_x - uv_c), np.linalg.norm(uv_y - uv_c))

        grad = _igehy_uv_gradient(
            scene.triangles, jnp.asarray([tri]), rec,
            jnp.asarray(d[None].astype(np.float32)), uniforms, static, 0)
        g = float(np.asarray(grad)[0])
        # forward differences vs the analytic derivative at the pixel
        # center differ at first order under perspective — ~10% at 64px
        assert abs(g - fd) / fd < 0.12, (g, fd)


def test_igehy_gradient_grazing_is_finite():
    """Near-edge-on triangles must fall back (0), not NaN."""
    W, H = 32, 32
    settings = RenderSettings()
    settings.cameraTarget = (0.0, 0.0, -1.0)
    settings.cameraDistance = 2.0
    settings.cameraVerticalFov = 45.0
    scene = _quad_scene()
    static = settings_to_static(settings, W, H, (0,))
    cam = build_camera(settings, W, H)
    uniforms = settings_to_uniforms(settings, cam, 0, 0)
    o, d = _pixel_ray(cam, 16, 16, W, H)
    _, rec, tri = _uv_at(scene, o, d)
    # force a degenerate direction nearly parallel to the quad
    d_graze = np.array([1.0, 0.0, -1e-9], np.float32)
    grad = _igehy_uv_gradient(
        scene.triangles, jnp.asarray([tri]),
        rec.replace(normal=jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32)),
        jnp.asarray(d_graze[None]), uniforms, static, 0)
    assert np.isfinite(np.asarray(grad)).all()
