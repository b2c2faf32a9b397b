"""Image writer round-trip and tonemap tests
(reference: src/renderer/ImageWriter.mm)."""

import numpy as np
import pytest

from metal_pathtracer.utils import image_io


@pytest.fixture
def hdr():
    rng = np.random.default_rng(7)
    return rng.uniform(0.0, 4.0, size=(13, 17, 3)).astype(np.float32)


def test_ppm_roundtrip(tmp_path, hdr):
    path = str(tmp_path / "img.ppm")
    image_io.write_ppm(path, hdr)
    back = image_io.read_ppm(path)
    assert back.shape == hdr.shape
    expect = image_io.tonemap_to_u8(hdr, image_io.TonemapSettings())
    np.testing.assert_array_equal(back, expect)


def test_ppm_header_is_reference_format(tmp_path):
    img = np.zeros((2, 3, 3), np.float32)
    path = str(tmp_path / "img.ppm")
    image_io.write_ppm(path, img)
    data = open(path, "rb").read()
    assert data.startswith(b"P6\n3 2\n255\n")
    assert len(data) == 11 + 2 * 3 * 3


def test_pfm_roundtrip(tmp_path, hdr):
    path = str(tmp_path / "img.pfm")
    image_io.write_pfm(path, hdr)
    back = image_io.read_pfm(path)
    np.testing.assert_allclose(back, hdr, rtol=1e-7)


def test_exr_roundtrip(tmp_path, hdr):
    path = str(tmp_path / "img.exr")
    image_io.write_exr_rgb(path, hdr)
    ch = image_io.read_exr(path)
    np.testing.assert_allclose(ch["R"], hdr[..., 0], rtol=1e-7)
    np.testing.assert_allclose(ch["G"], hdr[..., 1], rtol=1e-7)
    np.testing.assert_allclose(ch["B"], hdr[..., 2], rtol=1e-7)


def test_exr_multilayer_channels(tmp_path, hdr):
    path = str(tmp_path / "layers.exr")
    samples = np.full(hdr.shape[:2], 7, np.uint32)
    image_io.write_exr_multilayer(path, hdr, albedo=hdr * 0.5,
                                  normal=hdr * 0.25, samples=samples)
    ch = image_io.read_exr(path)
    assert set(ch) == {"R", "G", "B", "albedo.R", "albedo.G", "albedo.B",
                       "normal.R", "normal.G", "normal.B", "SAMPLES"}
    np.testing.assert_allclose(ch["SAMPLES"], 7.0)
    np.testing.assert_allclose(ch["albedo.G"], hdr[..., 1] * 0.5, rtol=1e-7)


def test_exr_openable_by_external_reader(tmp_path, hdr):
    """If imageio/OpenEXR is available, our files must parse there too."""
    path = str(tmp_path / "img.exr")
    image_io.write_exr_rgb(path, hdr)
    try:
        import OpenEXR  # noqa
        have = True
    except ImportError:
        have = False
    if not have:
        pytest.skip("no external EXR reader in image")
    import OpenEXR
    f = OpenEXR.InputFile(path)
    assert f.header() is not None


def test_png_valid_structure(tmp_path, hdr):
    import zlib
    path = str(tmp_path / "img.png")
    image_io.write_png(path, hdr)
    data = open(path, "rb").read()
    assert data.startswith(b"\x89PNG\r\n\x1a\n")
    assert b"IHDR" in data and b"IDAT" in data and data.endswith(
        b"IEND" + (zlib.crc32(b"IEND") & 0xFFFFFFFF).to_bytes(4, "big"))


def test_tonemap_linear_matches_reference_math():
    # linear mode: clamp then gamma 1/2.2 then lround
    hdr = np.array([[[0.0, 0.5, 2.0]]], np.float32)
    u8 = image_io.tonemap_to_u8(hdr, image_io.TonemapSettings(tonemapMode=1))
    want = np.array([0, round(0.5 ** (1 / 2.2) * 255), 255])
    np.testing.assert_array_equal(u8[0, 0], want)


def test_tonemap_aces_modes_differ():
    hdr = np.full((1, 1, 3), 1.5, np.float32)
    fitted = image_io.tonemap_to_u8(hdr, image_io.TonemapSettings(tonemapMode=2, acesVariant=0))
    simple = image_io.tonemap_to_u8(hdr, image_io.TonemapSettings(tonemapMode=2, acesVariant=1))
    linear = image_io.tonemap_to_u8(hdr, image_io.TonemapSettings(tonemapMode=1))
    assert not np.array_equal(fitted, linear)
    assert not np.array_equal(fitted, simple)
