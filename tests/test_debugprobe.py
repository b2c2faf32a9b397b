"""Debug probe: replay a pixel's bounce history (VERDICT r01 #9; the
reference's PathtraceDebugBuffer ring equivalent)."""

import numpy as np

from metal_pathtracer import constants as C
from metal_pathtracer.ops.camera import build_camera
from metal_pathtracer.renderer.debugprobe import probe_pixel
from metal_pathtracer.scene import dsl
from metal_pathtracer.scene.resources import SceneResources
from metal_pathtracer.schema import settings_to_static, settings_to_uniforms
from metal_pathtracer.settings import RenderSettings

SCENE = """\
camera target=0,0,-1 distance=3.5 yaw=0 pitch=0 vfov=45
renderer maxDepth=6 seed=1337
background solid=0.7,0.8,1.0
material type=lambert albedo=0.8,0.3,0.3
material type=glass ior=1.5
sphere center=0,0,-1 radius=0.5 material=1
sphere center=0,-100.5,-1 radius=100 material=0
"""


def setup(w=64, h=64):
    settings = RenderSettings()
    res = SceneResources()
    dsl.parse_scene(SCENE, settings, res)
    scene = res.build_arrays()
    static = settings_to_static(settings, w, h,
                                res.material_types_present())
    cam = build_camera(settings, w, h)
    uni = settings_to_uniforms(settings, cam, 0, 0)
    return scene, uni, static


def test_probe_center_pixel_hits_glass_sphere():
    scene, uni, static = setup()
    rows = probe_pixel(scene, uni, static, 32, 32)
    assert len(rows) >= 2, "glass path should bounce at least twice"
    first = rows[0]
    assert first["hit"] == 1.0
    assert first["prim_type"] == C.PRIMITIVE_SPHERE
    assert first["prim_index"] == 0          # the glass sphere
    assert first["material"] == 1
    assert first["is_delta"] == 1.0          # dielectric = delta
    # t is parametric along the unnormalized RTOW ray (t=1 = focus plane
    # at the target): the sphere front face sits just before it
    assert 0.5 < first["t"] < 1.0
    # throughput stays finite and positive along the path
    for row in rows:
        tp = (row["throughput_r"], row["throughput_g"], row["throughput_b"])
        assert all(np.isfinite(tp))
    # dielectric entry pushes the medium stack on a transmission bounce
    events = [row["medium_event"] for row in rows]
    assert any(e == 1 for e in events) or all(e == 0 for e in events)


def test_probe_sky_pixel_terminates_immediately():
    scene, uni, static = setup()
    rows = probe_pixel(scene, uni, static, 1, 0)  # sky corner (verify doc:
    # the smoke-scene corner pixel is solid sky)
    assert rows[0]["hit"] == 0.0
    assert len(rows) == 1


def test_probe_is_deterministic():
    scene, uni, static = setup()
    a = probe_pixel(scene, uni, static, 32, 40)
    b = probe_pixel(scene, uni, static, 32, 40)
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        for k in ra:
            assert ra[k] == rb[k], k
