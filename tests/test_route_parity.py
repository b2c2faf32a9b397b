"""Kernel traversal route vs XLA traversal route, through the integrator.

Every scene below reaches triangles or instanced groups. Each renders
twice through renderer/frame.py: once with the traversal kernel (under the
Pallas interpreter) and once with the XLA while-loop. The routes run the
same slab and Möller–Trumbore arithmetic, but XLA compiles each program's
multiply-adds on its own, so hit t/u/v can differ by an ulp; a lane that
then flips a branch (Fresnel lobe, Russian roulette) takes another path.
So the images match statistically: ray counts within 1e-4, RMSE < 5e-4 on
linear HDR, and >= 95% of pixels within 1e-4. Car paint under an HDR env
gets RMSE < 2e-2: its flake normal is a hash of the hit position, so an
ulp in t picks another flake, and one such lane under the sun block moves
a pixel by ~0.5.

A second part fuzzes the hit merge directly: random soups of triangles,
spheres, rects and instanced groups, where trace_scene and trace_occluded
must agree between the routes lane by lane.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest

from metal_pathtracer import constants as C
from metal_pathtracer.renderer import frame
from metal_pathtracer.renderer.accumulation import RenderState
from metal_pathtracer.scene.resources import (
    Material,
    Mesh,
    Rect,
    SceneResources,
    Sphere,
)
from metal_pathtracer.settings import BackgroundMode, RenderSettings, SssMode
from metal_pathtracer.utils.benchscene import _ground_mesh, _sphere_mesh, \
    frame_inputs
from metal_pathtracer.utils.procgen import dragon_class_mesh, \
    dragon_class_scene_mesh


def _settings(target=(0.0, 0.6, 0.0), distance=5.0, yaw=0.0, pitch=0.3,
              depth=4, seed=9, background=None):
    s = RenderSettings()
    s.cameraTarget = target
    s.cameraDistance = distance
    s.cameraYaw = yaw
    s.cameraPitch = pitch
    s.maxDepth = depth
    s.fixedRngSeed = seed
    if background is not None:
        s.backgroundMode = background
    return s


def _toy_env():
    from metal_pathtracer.ops import env as env_ops

    h, w = 16, 32
    texels = np.full((h, w, 3), 0.25, np.float32)
    texels[3:6, 6:9] = (40.0, 35.0, 28.0)   # hot sun block
    texels[:, :, 2] += 0.15                  # blue-ish sky
    return env_ops.environment_from_texels(jnp.asarray(texels))


def _bench_like(textured):
    """The headline configuration at toy scale: HDR env alias NEE +
    dielectric + (textured) PBR + lambert."""
    from metal_pathtracer.utils.benchscene import build_bench_scene

    settings, res, environment = build_bench_scene(subdivisions=3)
    settings.maxDepth = 5
    if not textured:
        res.texture_images.clear()
        res.texture_srgb.clear()
        res.texture_wrap.clear()
        for m in res.materials:
            m.texture_indices = (-1, -1, -1, -1, -1, -1)
    return settings, res, environment


def lambert_gradient():
    s = _settings((0.0, 0.0, 0.0), 3.2, 0.4, 0.25, 4, 1234)
    res = SceneResources()
    res.add_material(Material(base_color=(0.7, 0.7, 0.7)))
    res.add_mesh(dragon_class_scene_mesh(2, material=0))
    return s, res, None


def full_type_set():
    """metal (rough + mirror), absorbing dielectric, diffuse light."""
    s = _settings((0.0, 0.0, 0.0), 5.0, 0.0, 0.3, 6, 7)
    res = SceneResources()
    m0 = res.add_material(Material(base_color=(0.7, 0.5, 0.4)))
    m1 = res.add_material(Material(mat_type=C.MATERIAL_DIELECTRIC, ior=1.5,
                                   dielectric_sigma_a=(0.2, 0.1, 0.02)))
    m2 = res.add_material(Material(mat_type=C.MATERIAL_METAL,
                                   base_color=(0.9, 0.7, 0.4),
                                   roughness=0.3))
    m3 = res.add_material(Material(mat_type=C.MATERIAL_METAL,
                                   base_color=(0.9, 0.9, 0.9),
                                   roughness=0.0))
    m4 = res.add_material(Material(mat_type=C.MATERIAL_DIFFUSE_LIGHT,
                                   emission=(6.0, 5.0, 4.0)))
    res.add_mesh(_sphere_mesh(2, (0, 0, 0), 1.0, m1, "glass"))
    res.add_mesh(_sphere_mesh(2, (-2.2, 0, 0), 1.0, m2, "metal-r"))
    res.add_mesh(_sphere_mesh(2, (2.2, 0, 0), 1.0, m3, "mirror"))
    res.add_mesh(_sphere_mesh(1, (0, 2.0, 0), 0.5, m4, "lamp"))
    res.add_mesh(_ground_mesh(m0))
    return s, res, None


def solid_background_rr():
    """Solid background + deep depth so Russian roulette branches run."""
    s = _settings((0.0, 0.0, 0.0), 3.0, 0.0, 0.0, 8, 99,
                  BackgroundMode.SOLID)
    s.backgroundColor = (0.9, 0.6, 0.3)
    res = SceneResources()
    res.add_material(Material(base_color=(0.85, 0.85, 0.85)))
    res.add_mesh(dragon_class_scene_mesh(2, material=0))
    res.add_mesh(_ground_mesh(0))
    return s, res, None


def mixed_prims_light_sphere():
    """Triangles + spheres + a rect + an emissive sphere in one merge."""
    s = _settings((0.0, 0.5, 0.0), 4.5, -0.4, 0.2, 5, 4242)
    res = SceneResources()
    m_mesh = res.add_material(Material(base_color=(0.6, 0.3, 0.3)))
    m_s = res.add_material(Material(base_color=(0.3, 0.4, 0.7)))
    m_l = res.add_material(Material(mat_type=C.MATERIAL_DIFFUSE_LIGHT,
                                    emission=(9.0, 8.0, 7.0)))
    m_r = res.add_material(Material(base_color=(0.5, 0.5, 0.45)))
    res.add_mesh(dragon_class_scene_mesh(2, material=m_mesh))
    res.spheres.append(Sphere(center=(1.4, 0.4, 0.6), radius=0.4,
                              material=m_s))
    res.spheres.append(Sphere(center=(-1.2, 1.6, -0.5), radius=0.35,
                              material=m_l))
    res.rects.append(Rect(
        corner=np.array([-3, -0.8, -3], np.float32),
        edge_u=np.array([6, 0, 0], np.float32),
        edge_v=np.array([0, 0, 6], np.float32),
        normal=np.array([0, 1, 0], np.float32),
        material=m_r, two_sided=False))
    return s, res, None


def instanced():
    """Instanced groups (per-instance self-exclusion) + a soup ground."""
    s = _settings((0.0, 0.0, 0.0), 7.0, 0.0, 0.35, 4, 55)
    res = SceneResources()
    m0 = res.add_material(Material(base_color=(0.7, 0.4, 0.3)))
    m_g = res.add_material(Material(base_color=(0.5, 0.5, 0.55)))
    pos, normals, faces = dragon_class_mesh(2)
    uv = np.zeros((len(pos), 2), np.float32)
    src = Mesh(name="blob", vertices=pos, normals=normals, uv0=uv,
               uv1=uv.copy(), tangents=np.zeros((len(pos), 4), np.float32),
               indices=faces, material=m0)
    for i, (tx, sc, ry) in enumerate([(-2.2, 0.8, 0.3), (0.0, 1.0, 0.0),
                                      (2.3, 1.25, -0.7)]):
        c, sn = math.cos(ry), math.sin(ry)
        m = np.eye(4)
        m[:3, :3] = np.array([[c, 0, sn], [0, 1, 0], [-sn, 0, c]]) * sc
        m[:3, 3] = [tx, 0.15 * i, 0.0]
        res.add_mesh_instance(src, m)
    res.add_mesh(_ground_mesh(m_g))
    return s, res, None


def env_specnee_glass():
    """Spec-NEE delta chains with an env map and a glass mesh."""
    s, res, environment = _bench_like(False)
    s.enableSpecularNee = True
    s.enableMnee = False
    m_glass = res.add_material(Material(mat_type=C.MATERIAL_DIELECTRIC,
                                        ior=1.5))
    res.add_mesh(_sphere_mesh(2, (0.0, 1.8, 0.0), 0.7, m_glass, "orb"))
    return s, res, environment


def pbr_untextured():
    s = _settings((0.0, 0.0, 0.0), 4.0, 0.0, 0.3, 5, 21)
    res = SceneResources()
    g = res.add_material(Material(base_color=(0.6, 0.6, 0.6)))
    p1 = res.add_material(Material(mat_type=C.MATERIAL_PBR,
                                   base_color=(0.8, 0.3, 0.2),
                                   roughness=0.4, pbr_metallic=0.8))
    p2 = res.add_material(Material(mat_type=C.MATERIAL_PBR,
                                   base_color=(0.9, 0.9, 0.9),
                                   roughness=0.1, pbr_transmission=0.9,
                                   ior=1.5, pbr_thickness=0.3,
                                   dielectric_sigma_a=(0.5, 0.1, 0.1)))
    res.add_mesh(_sphere_mesh(2, (-1.3, 0, 0), 1.0, p1, "metallic"))
    res.add_mesh(_sphere_mesh(2, (1.3, 0, 0), 1.0, p2, "transmissive"))
    res.add_mesh(_ground_mesh(g))
    return s, res, None


def env_nee_untextured():
    return _bench_like(False)


def env_nee_textured():
    return _bench_like(True)


def textured_pbr_mixed_prims():
    """Textured PBR soup triangles + an analytic floor and sphere."""
    s, res, environment = _bench_like(True)
    m_floor = res.add_material(Material(base_color=(0.6, 0.55, 0.5)))
    m_metal = res.add_material(Material(
        mat_type=C.MATERIAL_METAL, base_color=(0.9, 0.7, 0.4),
        roughness=0.05))
    res.rects.append(Rect(
        corner=np.array([-40.0, 0.0, -40.0], np.float32),
        edge_u=np.array([80.0, 0.0, 0.0], np.float32),
        edge_v=np.array([0.0, 0.0, 80.0], np.float32),
        normal=np.array([0.0, 1.0, 0.0], np.float32),
        material=m_floor, two_sided=False))
    res.spheres.append(Sphere(center=(-1.6, 0.6, 0.4), radius=0.6,
                              material=m_metal))
    return s, res, environment


def multislot_textures():
    """Base + ORM + normal map + occlusion + emissive slots, alpha MASK
    cutouts and alpha BLEND on triangle spheres."""
    rng = np.random.default_rng(3)

    def tex(h, w, lo, hi):
        out = np.full((h, w, 4), 255, np.uint8)
        out[..., :3] = np.clip((lo + (hi - lo) * rng.random((h, w, 3)))
                               * 255.0, 0, 255).astype(np.uint8)
        return out

    s = _settings((0.0, 0.5, 0.0), 4.5, 0.0, 0.25, 4, 11)
    res = SceneResources()
    nm = np.full((8, 8, 4), 255, np.uint8)
    nm[..., 0] = (128 + 76 * (rng.random((8, 8)) - 0.5)).astype(np.uint8)
    nm[..., 1] = (128 + 76 * (rng.random((8, 8)) - 0.5)).astype(np.uint8)
    mask = np.full((8, 8, 4), 204, np.uint8)
    mask[::2, ::2, 3] = 25                               # cutout texels
    for img, srgb in ((tex(16, 16, 0.2, 0.9), True),
                      (tex(8, 8, 0.1, 1.0), False), (nm, False),
                      (tex(8, 8, 0.4, 1.0), True), (mask, True)):
        res.texture_images.append(img)
        res.texture_srgb.append(srgb)
        res.texture_wrap.append((0, 0))
    m_full = res.add_material(Material(
        mat_type=C.MATERIAL_PBR, base_color=(0.9, 0.8, 0.7),
        roughness=0.6, pbr_metallic=0.4, emission=(0.5, 0.4, 0.3),
        texture_indices=(0, 1, 2, 1, 3, -1)))
    m_mask = res.add_material(Material(
        mat_type=C.MATERIAL_PBR, base_color=(0.3, 0.6, 0.9),
        roughness=0.8, pbr_alpha_mode=1, pbr_alpha_cutoff=0.5,
        texture_indices=(4, -1, -1, -1, -1, -1)))
    m_blend = res.add_material(Material(
        mat_type=C.MATERIAL_PBR, base_color=(0.8, 0.3, 0.3),
        roughness=0.5, pbr_alpha_mode=2, pbr_alpha=0.55,
        texture_indices=(0, -1, -1, -1, -1, -1)))
    m_ground = res.add_material(Material(base_color=(0.6, 0.6, 0.6)))
    res.add_mesh(_sphere_mesh(2, (0, 0.6, 0), 0.8, m_full, "full"))
    res.add_mesh(_sphere_mesh(2, (-1.9, 0.6, 0), 0.8, m_mask, "mask"))
    res.add_mesh(_sphere_mesh(2, (1.9, 0.6, 0), 0.8, m_blend, "blend"))
    res.add_mesh(_ground_mesh(m_ground))
    return s, res, None


def _on_ground(material, depth=4, seed=9, background=None, name="obj"):
    s = _settings(depth=depth, seed=seed, background=background)
    res = SceneResources()
    m = res.add_material(material)
    m_ground = res.add_material(Material(base_color=(0.6, 0.6, 0.6)))
    res.add_mesh(_sphere_mesh(2, (0.0, 0.6, 0), 0.8, m, name))
    res.add_mesh(_ground_mesh(m_ground))
    env = _toy_env() if background == BackgroundMode.ENVIRONMENT else None
    return s, res, env


def plastic():
    s = _settings(seed=9)
    res = SceneResources()
    m_red = res.add_material(Material(
        mat_type=C.MATERIAL_PLASTIC, base_color=(0.6, 0.1, 0.1),
        coat_roughness=0.15, coat_thickness=0.4,
        coat_tint=(0.9, 0.95, 1.0), coat_absorption=(0.2, 0.1, 0.05),
        ior=1.5))
    m_rough = res.add_material(Material(
        mat_type=C.MATERIAL_PLASTIC, base_color=(0.1, 0.4, 0.7),
        coat_roughness=0.3, ior=1.6))
    m_ground = res.add_material(Material(base_color=(0.6, 0.6, 0.6)))
    res.add_mesh(_sphere_mesh(2, (-1.0, 0.6, 0), 0.8, m_red, "red"))
    res.add_mesh(_sphere_mesh(2, (1.0, 0.6, 0), 0.8, m_rough, "rough"))
    res.add_mesh(_ground_mesh(m_ground))
    return s, res, None


def plastic_smooth_primary():
    return _on_ground(Material(mat_type=C.MATERIAL_PLASTIC,
                               base_color=(0.1, 0.4, 0.7),
                               coat_roughness=0.02, ior=1.6), depth=1)


def plastic_env():
    return _on_ground(Material(mat_type=C.MATERIAL_PLASTIC,
                               base_color=(0.5, 0.25, 0.1),
                               coat_roughness=0.2, coat_thickness=0.2,
                               ior=1.5), depth=3, seed=11,
                      background=BackgroundMode.ENVIRONMENT)


_CARPAINT = dict(mat_type=C.MATERIAL_CARPAINT, coat_roughness=0.2,
                 carpaint_base_metallic=0.3, carpaint_base_roughness=0.25,
                 carpaint_flake_sample_weight=0.2,
                 carpaint_flake_roughness=0.2, carpaint_flake_scale=8.0,
                 carpaint_flake_normal_strength=0.5, ior=1.5)


def carpaint():
    return _on_ground(Material(base_color=(0.5, 0.05, 0.05), **_CARPAINT),
                      depth=3, seed=13)


def carpaint_env():
    return _on_ground(Material(base_color=(0.1, 0.2, 0.6),
                               carpaint_base_eta=(1.2, 0.9, 0.6),
                               carpaint_base_k=(3.0, 2.5, 2.0),
                               **_CARPAINT),
                      depth=3, seed=17,
                      background=BackgroundMode.ENVIRONMENT)


def _sss(method, mode, background=None):
    s, res, env = _on_ground(Material(
        mat_type=C.MATERIAL_SUBSURFACE, base_color=(0.8, 0.4, 0.2),
        sss_mfp=0.25, sss_g=0.2, sss_method=method, ior=1.4), seed=23,
        background=background)
    s.sssMode = mode
    return s, res, env


def sss_fallback():
    return _sss(0, SssMode.OFF)


def sss_separable():
    return _sss(0, SssMode.SEPARABLE)


def sss_random_walk():
    return _sss(1, SssMode.RANDOM_WALK)


def sss_random_walk_env():
    return _sss(1, SssMode.RANDOM_WALK, BackgroundMode.ENVIRONMENT)


SCENES = [lambert_gradient, full_type_set, solid_background_rr,
          mixed_prims_light_sphere, instanced, env_specnee_glass,
          pbr_untextured, env_nee_untextured, env_nee_textured,
          textured_pbr_mixed_prims, multislot_textures, plastic,
          plastic_smooth_primary, plastic_env, carpaint, carpaint_env,
          sss_fallback, sss_separable, sss_random_walk, sss_random_walk_env]


def _render(settings, res, env, route, w=40, h=24, spp=2):
    scene, static, uni = frame_inputs(settings, res, env, w, h, route)
    st = frame.render_samples(scene, uni, RenderState.create(w, h), static,
                              spp)
    return (np.asarray(st.present()), float(np.asarray(st.ray_count)),
            float(np.asarray(st.shadow_ray_count)))


MAX_RMSE = {"carpaint_env": 2e-2}


@pytest.mark.parametrize("build", SCENES, ids=[f.__name__ for f in SCENES])
def test_kernel_route_matches_xla_route(build):
    settings, res, env = build()
    img_x, rays_x, shadow_x = _render(settings, res, env, "xla")
    img_k, rays_k, shadow_k = _render(settings, res, env, "interpret")
    assert rays_x > 0
    assert abs(rays_k - rays_x) <= max(4.0, 1e-4 * rays_x)
    assert abs(shadow_k - shadow_x) <= max(4.0, 1e-4 * shadow_x)
    d = np.abs(img_k - img_x)
    rmse = float(np.sqrt((d * d).mean()))
    assert np.isfinite(img_k).all()
    assert rmse < MAX_RMSE.get(build.__name__, 5e-4), (rmse, float(d.max()))
    assert float((d.max(-1) < 1e-4).mean()) >= 0.95


# ---------------------------------------------------------------------------
# Hit-merge fuzz: random mixed scenes, both routes lane by lane


def _random_scene(rng, route, n_tris=40, n_spheres=12, n_rects=4,
                  with_instances=True):
    res = SceneResources()
    m0 = res.add_material(Material(base_color=(0.7, 0.7, 0.7)))
    if n_tris:
        base = rng.uniform(-6, 6, size=(n_tris, 1, 3))
        verts = (base + rng.uniform(-0.7, 0.7, size=(n_tris, 3, 3))
                 ).astype(np.float32)
        v = verts.reshape(-1, 3)
        uv = np.zeros((len(v), 2), np.float32)
        res.add_mesh(Mesh(name="soup", vertices=v,
                          normals=np.tile(np.array([[0, 1, 0]], np.float32),
                                          (len(v), 1)),
                          uv0=uv, uv1=uv.copy(),
                          tangents=np.zeros((len(v), 4), np.float32),
                          indices=np.arange(3 * n_tris, dtype=np.int32
                                            ).reshape(-1, 3),
                          material=m0))
    for _ in range(n_spheres):
        c = rng.uniform(-6, 6, 3)
        res.spheres.append(Sphere(center=tuple(float(x) for x in c),
                                  radius=float(rng.uniform(0.2, 1.0)),
                                  material=m0))
    for _ in range(n_rects):
        corner = rng.uniform(-6, 6, 3).astype(np.float32)
        eu = rng.normal(size=3).astype(np.float32)
        ev = rng.normal(size=3).astype(np.float32)
        nrm = np.cross(eu, ev)
        nl = np.linalg.norm(nrm)
        if nl < 1e-6:
            continue
        res.rects.append(Rect(corner=corner, edge_u=eu, edge_v=ev,
                              normal=(nrm / nl).astype(np.float32),
                              material=m0, two_sided=bool(rng.integers(2))))
    if with_instances:
        base = rng.uniform(-2, 2, size=(8, 1, 3))
        verts = (base + rng.uniform(-0.5, 0.5, size=(8, 3, 3))
                 ).astype(np.float32)
        v = verts.reshape(-1, 3)
        uv = np.zeros((len(v), 2), np.float32)
        src = Mesh(name="inst", vertices=v,
                   normals=np.tile(np.array([[0, 1, 0]], np.float32),
                                   (len(v), 1)),
                   uv0=uv, uv1=uv.copy(),
                   tangents=np.zeros((len(v), 4), np.float32),
                   indices=np.arange(24, dtype=np.int32).reshape(-1, 3),
                   material=m0)
        for k in range(2):
            ry = float(rng.uniform(0, math.pi))
            cs, sn = math.cos(ry), math.sin(ry)
            m = np.eye(4)
            m[:3, :3] = np.array([[cs, 0, sn], [0, 1, 0],
                                  [-sn, 0, cs]]) * (0.7 + 0.4 * k)
            m[:3, 3] = rng.uniform(-4, 4, 3)
            res.add_mesh_instance(src, m)
    return res.build_arrays(traversal=route)


def _fuzz_rays(rng, n=512):
    o = rng.uniform(-8, 8, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_trace_scene_routes_agree(seed):
    from metal_pathtracer.ops import intersect

    scenes = {route: _random_scene(np.random.default_rng(seed), route,
                                   with_instances=seed != 1,
                                   n_tris=8 if seed == 2 else 40)
              for route in ("xla", "interpret")}
    o, d = _fuzz_rays(np.random.default_rng(100 + seed))
    tmax = jnp.full((o.shape[0],), C.INFINITY_T, jnp.float32)
    a = intersect.trace_scene(o, d, scenes["interpret"], C.EPSILON_T, tmax)
    b = intersect.trace_scene(o, d, scenes["xla"], C.EPSILON_T, tmax)
    hit = np.asarray(b.hit)
    np.testing.assert_array_equal(np.asarray(a.hit), hit)
    assert hit.any()
    for f in ("prim_type", "prim_index", "mesh_index", "material",
              "front_face"):
        np.testing.assert_array_equal(np.asarray(getattr(a, f))[hit],
                                      np.asarray(getattr(b, f))[hit])
    np.testing.assert_allclose(np.asarray(a.t)[hit], np.asarray(b.t)[hit],
                               rtol=1e-5)


@pytest.mark.parametrize("seed", [0, 3])
def test_trace_occluded_routes_agree(seed):
    from metal_pathtracer.ops import intersect

    scenes = {route: _random_scene(np.random.default_rng(seed), route)
              for route in ("xla", "interpret")}
    rng = np.random.default_rng(200 + seed)
    o, d = _fuzz_rays(rng)
    # mixed windows incl. zero (dead lanes) and short segments
    tmax = jnp.asarray(rng.choice([0.0, 2.5, C.INFINITY_T],
                                  size=o.shape[0]).astype(np.float32))
    got = intersect.trace_occluded(o, d, scenes["interpret"], C.EPSILON_T,
                                   tmax)
    want = intersect.trace_occluded(o, d, scenes["xla"], C.EPSILON_T, tmax)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert np.asarray(want).any()
