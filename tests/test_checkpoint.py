"""Checkpoint/resume of the progressive render state (SURVEY.md §5.4).

The accumulator seeds every sample from the absolute sample index
(state.frame_index), so a run interrupted at N spp and resumed to M spp
must be bit-identical to an uninterrupted M-spp run.
"""

import numpy as np

from metal_pathtracer.renderer.headless import JaxBackend
from metal_pathtracer.scene import dsl
from metal_pathtracer.scene.resources import SceneResources
from metal_pathtracer.settings import RenderSettings

SCENE = """\
camera target=0,0,-1 distance=3.5 yaw=0 pitch=0 vfov=45
renderer maxDepth=4 seed=1337
background solid=0.7,0.8,1.0
material type=lambert albedo=0.8,0.3,0.3
material type=lambert albedo=0.8,0.8,0.0
sphere center=0,0,-1 radius=0.5 material=0
sphere center=0,-100.5,-1 radius=100 material=1
"""


def _scene():
    settings = RenderSettings()
    res = SceneResources()
    dsl.parse_scene(SCENE, settings, res)
    return settings, res


def test_resume_bit_identical(tmp_path):
    settings, res = _scene()
    w = h = 16
    backend = JaxBackend()

    straight = backend.render(res, settings, w, h, 16)

    ckpt = str(tmp_path / "state.ckpt")
    part1 = backend.render(res, settings, w, h, 8, checkpoint_path=ckpt)
    assert part1.samples == 8
    resumed = backend.render(res, settings, w, h, 16, checkpoint_path=ckpt)
    assert resumed.samples == 16

    np.testing.assert_array_equal(resumed.linear_rgb, straight.linear_rgb)
    np.testing.assert_array_equal(resumed.sample_count, straight.sample_count)


def test_resume_noop_when_done(tmp_path):
    settings, res = _scene()
    w = h = 16
    backend = JaxBackend()
    ckpt = str(tmp_path / "state.ckpt")
    first = backend.render(res, settings, w, h, 8, checkpoint_path=ckpt)
    again = backend.render(res, settings, w, h, 8, checkpoint_path=ckpt)
    assert again.samples == 8
    np.testing.assert_array_equal(again.linear_rgb, first.linear_rgb)


def test_resume_rejects_resolution_mismatch(tmp_path):
    import pytest

    from metal_pathtracer.renderer.accumulation import CheckpointError

    settings, res = _scene()
    backend = JaxBackend()
    ckpt = str(tmp_path / "state.ckpt")
    backend.render(res, settings, 16, 16, 2, checkpoint_path=ckpt)
    with pytest.raises(CheckpointError, match="32x32"):
        backend.render(res, settings, 32, 32, 4, checkpoint_path=ckpt)


def test_resume_rejects_scene_mismatch(tmp_path):
    import pytest

    from metal_pathtracer.renderer.accumulation import CheckpointError

    settings, res = _scene()
    backend = JaxBackend()
    ckpt = str(tmp_path / "state.ckpt")
    backend.render(res, settings, 16, 16, 2, checkpoint_path=ckpt)

    other_settings, other_res = _scene()
    other_settings.maxDepth = 7  # radiometrically different render
    with pytest.raises(CheckpointError, match="digest"):
        backend.render(other_res, other_settings, 16, 16, 4,
                       checkpoint_path=ckpt)
