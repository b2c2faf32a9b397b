"""Renderer facade + denoise/display tests
(reference: include/MetalRenderer.h public API surface)."""

import numpy as np
import pytest

from metal_pathtracer.renderer.renderer import Renderer
from metal_pathtracer.settings import RenderSettings


@pytest.fixture(scope="module")
def renderer(tmp_path_factory):
    r = Renderer(width=24, height=24)
    r.set_default_scene()
    r.settings.maxDepth = 3
    r.settings.fixedRngSeed = 11
    r.settings.samplesPerFrame = 1
    r._applied_settings = r.settings.copy()
    r.draw_frame()
    return r


def test_progressive_accumulation(renderer):
    before = renderer.sample_count()
    renderer.draw_frame()
    assert renderer.sample_count() == before + 1


def test_capture_average_image(renderer):
    img = renderer.capture_average_image()
    assert img.shape == (24, 24, 3)
    assert np.isfinite(img).all()
    assert img.max() > 0.0


def test_apply_settings_resets_on_radiometric_change(renderer):
    renderer.draw_frame()
    assert renderer.sample_count() > 0
    s = renderer.settings.copy()
    s.cameraYaw += 0.1
    reason = renderer.apply_settings(s)
    assert reason == "CAMERA"
    assert renderer.sample_count() == 0
    # non-radiometric change: no reset
    renderer.draw_frame()
    s2 = renderer.settings.copy()
    s2.samplesPerFrame = 4
    assert renderer.apply_settings(s2) is None
    assert renderer.sample_count() == 1


def test_resize_policy():
    r = Renderer(width=100, height=100)
    r.set_default_scene()
    r.settings.renderScale = 2.0
    r.resize(6000, 6000)  # 2x scale -> 12000 clamps to 8192; 67MP halves down
    w, h = r.render_size
    assert w * h <= 16 * 1024 * 1024
    assert max(w, h) <= 8192


def test_export_and_checkpoint(tmp_path, renderer):
    renderer.draw_frame()
    ppm = tmp_path / "out.ppm"
    renderer.export_to_ppm(str(ppm))
    assert ppm.stat().st_size > 0

    exr = tmp_path / "out.exr"
    renderer.save_exr(str(exr))
    from metal_pathtracer.utils import image_io
    ch = image_io.read_exr(str(exr))
    assert "SAMPLES" in ch
    assert ch["SAMPLES"].max() == renderer.sample_count()

    ckpt = tmp_path / "state.npz"
    count = renderer.sample_count()
    renderer.save_checkpoint(str(ckpt))
    r2 = Renderer()
    r2.load_checkpoint(str(ckpt))
    assert int(np.asarray(r2.state.frame_index)) == count
    np.testing.assert_array_equal(np.asarray(r2.state.radiance_sum),
                                  np.asarray(renderer.state.radiance_sum))


def test_display_and_denoise(renderer):
    renderer.settings.bloomEnabled = True
    ldr = renderer.display()
    assert ldr.shape == (24, 24, 3)
    assert 0.0 <= ldr.min() and ldr.max() <= 1.0
    renderer.settings.bloomEnabled = False

    from metal_pathtracer.ops.denoise import denoise_state
    den = np.asarray(denoise_state(renderer.state, renderer.settings))
    assert den.shape == (24, 24, 3)
    assert np.isfinite(den).all()
    noisy = np.asarray(renderer.state.present())
    # a smoothing filter reduces local variance
    def local_var(img):
        return np.var(np.diff(img, axis=0)) + np.var(np.diff(img, axis=1))
    assert local_var(den) <= local_var(noisy) * 1.05


def test_gpu_backend_raises_on_init_failure(monkeypatch, capsys):
    """An accelerator that fails to start is an error: make_backend raises
    and the CLI exits non-zero, instead of rendering on the CPU."""
    import jax

    from metal_pathtracer import cli
    from metal_pathtracer.renderer import headless

    def boom(*_a, **_k):
        raise RuntimeError("no CUDA device")

    monkeypatch.setattr(jax, "devices", boom)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        headless.make_backend("gpu")
    with pytest.raises(RuntimeError):
        headless.make_backend("metal")
    rc = cli.main(["--width", "8", "--height", "8", "--sppTotal", "1",
                   "--backend", "gpu", "--output", "/dev/null"])
    assert rc != 0
    assert "failed to initialize" in capsys.readouterr().err
