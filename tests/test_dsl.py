"""Scene DSL grammar tests (reference: SceneManager.mm:795-2360)."""

import numpy as np
import pytest

from metal_pathtracer import constants as C
from metal_pathtracer.scene import dsl
from metal_pathtracer.scene.resources import SceneResources
from metal_pathtracer.settings import BackgroundMode, RenderSettings, SssMode


def parse(text):
    settings = RenderSettings()
    res = SceneResources()
    dsl.parse_scene(text, settings, res)
    return settings, res


def test_smoke_scene_parses():
    text = """\
camera target=0,0,-1 distance=3.5 yaw=0 pitch=0 vfov=45 defocusAngle=0.0 focusDist=3.5
renderer samplesPerFrame=1 maxDepth=4 enableSoftwareRayTracing=1 width=64 height=64
background solid=0.7,0.8,1.0

material type=lambert albedo=0.8,0.3,0.3
material type=lambert albedo=0.8,0.8,0.0

sphere center=0,0,-1 radius=0.5 material=0
sphere center=0,-100.5,-1 radius=100 material=1
"""
    settings, res = parse(text)
    assert settings.cameraTarget == (0.0, 0.0, -1.0)
    assert settings.cameraDistance == 3.5
    assert settings.maxDepth == 4
    assert settings.renderWidth == 64 and settings.renderHeight == 64
    assert settings.backgroundMode == BackgroundMode.SOLID
    assert settings.backgroundColor == (0.7, 0.8, 1.0)
    assert res.material_count() == 2
    assert len(res.spheres) == 2
    assert res.spheres[1].radius == 100.0


def test_line_continuation_and_comments():
    text = """\
# a comment
material type=metal \\
    albedo=0.9,0.9,0.9 fuzz=0.2
sphere center=0,0,0 radius=1 material=0
"""
    _, res = parse(text)
    assert res.material_count() == 1
    assert res.materials[0].mat_type == C.MATERIAL_METAL
    assert res.materials[0].roughness == pytest.approx(0.2)


def test_material_types_and_aliases():
    text = """\
material type=lambertian albedo=1,0,0
material type=metallic base=0,1,0 roughness=0.3
material type=glass ior=1.7 thin=on
material type=light emit=5,5,5
material type=plastic color=0.2,0.4,0.8 coatRoughness=0.1
material type=subsurface mfp=2.0 g=0.3 method=randomwalk
material type=car_paint baseMetallic=0.5 flakeDensity=1000000
"""
    _, res = parse(text)
    types = [m.mat_type for m in res.materials]
    assert types == [C.MATERIAL_LAMBERTIAN, C.MATERIAL_METAL, C.MATERIAL_DIELECTRIC,
                     C.MATERIAL_DIFFUSE_LIGHT, C.MATERIAL_PLASTIC,
                     C.MATERIAL_SUBSURFACE, C.MATERIAL_CARPAINT]
    glass = res.materials[2]
    assert glass.ior == pytest.approx(1.7) and glass.thin
    light = res.materials[3]
    assert light.ior == 1.0 and light.roughness == 0.0  # forced for lights
    sss = res.materials[5]
    assert sss.sss_mfp == pytest.approx(2.0)
    assert sss.sss_method == 1
    cp = res.materials[6]
    assert cp.carpaint_flake_sample_weight == pytest.approx(0.1)
    assert cp.carpaint_has_base_conductor


def test_named_materials():
    text = """\
material type=lambert name=red albedo=1,0,0
material type=lambert name=green albedo=0,1,0
"""
    _, res = parse(text)
    assert res.material_names == {"red": 0, "green": 1}


def test_rectangle_axis_rules():
    text = """\
material type=light emit=10,10,10
rectangle x=-1,1 y=2 z=-1,1 normal=-1 material=0
"""
    _, res = parse(text)
    assert len(res.rects) == 1
    r = res.rects[0]
    np.testing.assert_allclose(r.normal, [0, -1, 0], atol=1e-6)
    # two in-plane ranges + one fixed axis required
    with pytest.raises(dsl.SceneParseError):
        parse("material type=lambert\nrectangle x=1 y=2 z=-1,1 material=0")


def test_box_becomes_rectangles():
    text = """\
material type=lambert albedo=0.5,0.5,0.5
box min=0,0,0 max=1,1,1 material=0
box min=0,0,0 max=1,1,1 material=0 includeBottom=0
"""
    _, res = parse(text)
    assert len(res.rects) == 6 + 5


def test_box_transform():
    text = """\
material type=lambert albedo=0.5,0.5,0.5
box min=0,0,0 max=1,1,1 material=0 translate=2,0,0 rotateY=90
"""
    _, res = parse(text)
    assert len(res.rects) == 6
    corners = np.array([r.corner for r in res.rects])
    # rotated 90deg about Y then translated +2x: x in [2,3] approx
    assert corners[:, 0].min() >= 1.9 and corners[:, 0].max() <= 3.1


def test_renderer_settings_tokens():
    text = ("renderer maxDepth=12 seed=99 russianRoulette=0 tonemap=2 acesVariant=1 "
            "exposure=1.5 sss=separable sssMaxSteps=16 fireflyClampFactor=8 "
            "enableMnee=1 bloom=1 bloomThreshold=0.5\n")
    settings, _ = parse(text)
    assert settings.maxDepth == 12
    assert settings.fixedRngSeed == 99
    assert not settings.enableRussianRoulette
    assert settings.tonemapMode == 2 and settings.acesVariant == 1
    assert settings.exposure == pytest.approx(1.5)
    assert settings.sssMode == SssMode.SEPARABLE
    assert settings.sssMaxSteps == 16
    assert settings.fireflyClampFactor == pytest.approx(8.0)
    assert settings.enableMnee
    assert settings.bloomEnabled and settings.bloomThreshold == pytest.approx(0.5)


def test_undefined_material_reference_fails():
    with pytest.raises(dsl.SceneParseError):
        parse("sphere center=0,0,0 radius=1 material=0")


def test_unknown_keyword_ignored():
    settings, res = parse("frobnicate foo=1\nmaterial type=lambert\n")
    assert res.material_count() == 1


def test_sigma_from_absorption_thickness():
    _, res = parse("material type=glass absorption=1,2,4 thickness=2\n")
    np.testing.assert_allclose(res.materials[0].dielectric_sigma_a, (0.5, 1.0, 2.0))


def test_radiometric_change_detector():
    from metal_pathtracer.settings import detect_radiometric_change
    a = RenderSettings()
    b = a.copy()
    changed, _ = detect_radiometric_change(a, b)
    assert not changed
    b.cameraYaw = 1.0
    changed, reason = detect_radiometric_change(a, b)
    assert changed and reason == "CAMERA"
    b = a.copy()
    b.samplesPerFrame = 8  # non-radiometric
    changed, _ = detect_radiometric_change(a, b)
    assert not changed
