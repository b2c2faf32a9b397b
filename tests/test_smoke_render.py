"""End-to-end smoke render — the analogue of the reference's public smoke
test (reference: tests/public/headless_smoke_test.sh: 64x64, 4 spp,
maxDepth 4, seed 1337, solid sky, two lambert spheres).

Renders a reduced 32x32x2spp variant (CI speed), asserts determinism and
pins our own golden statistics.
"""

import numpy as np
import pytest

from metal_pathtracer.ops.camera import build_camera
from metal_pathtracer.renderer import frame
from metal_pathtracer.renderer.accumulation import RenderState
from metal_pathtracer.scene import dsl
from metal_pathtracer.scene.resources import SceneResources
from metal_pathtracer.schema import settings_to_static, settings_to_uniforms
from metal_pathtracer.settings import RenderSettings

SMOKE = """\
camera target=0,0,-1 distance=3.5 yaw=0 pitch=0 vfov=45 defocusAngle=0.0 focusDist=3.5
renderer samplesPerFrame=1 maxDepth=4 width=64 height=64
background solid=0.7,0.8,1.0
material type=lambert albedo=0.8,0.3,0.3
material type=lambert albedo=0.8,0.8,0.0
sphere center=0,0,-1 radius=0.5 material=0
sphere center=0,-100.5,-1 radius=100 material=1
"""


def render(width=32, height=32, spp=2, seed=1337):
    settings = RenderSettings()
    res = SceneResources()
    dsl.parse_scene(SMOKE, settings, res)
    settings.fixedRngSeed = seed
    settings.maxDepth = 4
    scene = res.build_arrays()
    static = settings_to_static(settings, width, height,
                                res.material_types_present())
    camera = build_camera(settings, width, height)
    uniforms = settings_to_uniforms(settings, camera, 0, 0)
    state = frame.render_samples(scene, uniforms,
                                 RenderState.create(width, height), static, spp)
    return state


@pytest.fixture(scope="module")
def state():
    return render()


def test_sample_counts(state):
    assert np.asarray(state.sample_count).min() == 2
    assert int(np.asarray(state.frame_index)) == 2


def test_image_plausible(state):
    img = np.asarray(state.present())
    assert np.isfinite(img).all()
    assert img.min() >= 0.0
    # Top corner is pure background through the gamma-free linear path
    np.testing.assert_allclose(img[0, 0], [0.7, 0.8, 1.0], atol=0.02)
    # The scene has red sphere + yellow ground: mean has R > B
    mean = img.mean(axis=(0, 1))
    assert mean[0] > mean[2] * 0.9
    assert 0.3 < mean.mean() < 0.9


def test_deterministic_across_runs(state):
    other = render()
    np.testing.assert_array_equal(np.asarray(state.present()),
                                  np.asarray(other.present()))


def test_seed_changes_image(state):
    other = render(seed=7)
    assert not np.array_equal(np.asarray(state.present()),
                              np.asarray(other.present()))


def test_progressive_equals_batched(state):
    """2 samples in one jitted call == 1+1 across calls (progressive
    accumulation invariance, the core of the reference's design)."""
    settings = RenderSettings()
    res = SceneResources()
    dsl.parse_scene(SMOKE, settings, res)
    settings.fixedRngSeed = 1337
    settings.maxDepth = 4
    scene = res.build_arrays()
    static = settings_to_static(settings, 32, 32, res.material_types_present())
    camera = build_camera(settings, 32, 32)
    uniforms = settings_to_uniforms(settings, camera, 0, 0)
    st = RenderState.create(32, 32)
    st = frame.render_samples(scene, uniforms, st, static, 1)
    st = frame.render_samples(scene, uniforms, st, static, 1)
    np.testing.assert_array_equal(np.asarray(st.radiance_sum),
                                  np.asarray(state.radiance_sum))


def test_aovs_recorded(state):
    albedo = np.asarray(state.albedo)
    # ground albedo is (0.8,0.8,0.0) and sphere (0.8,0.3,0.3): bottom rows hit ground
    np.testing.assert_allclose(albedo[-1, 16], [0.8, 0.8, 0.0], atol=1e-5)
    normal = np.asarray(state.normal)
    # ground normal near +Y at the bottom of the frame
    assert normal[-1, 16, 1] > 0.9


def test_ray_counter(state):
    rays = float(np.asarray(state.ray_count))
    # at least one primary ray per pixel per sample, at most maxDepth each
    assert 32 * 32 * 2 <= rays <= 32 * 32 * 2 * 4
