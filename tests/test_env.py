"""Environment importance sampling tests
(reference: src/renderer/EnvImportanceSampler.mm, pathtrace.metal:1326-1579)."""

import numpy as np
import pytest

from metal_pathtracer.ops import env as env_ops


def test_alias_table_uniform():
    p = np.full(8, 1.0 / 8, np.float32)
    alias, threshold = env_ops.build_alias_table(p)
    np.testing.assert_allclose(threshold, 1.0)


def test_alias_table_sampling_distribution():
    """Sampling through the alias table reproduces the distribution."""
    rng = np.random.default_rng(3)
    p = rng.uniform(0.1, 1.0, 16)
    p /= p.sum()
    alias, threshold = env_ops.build_alias_table(p.astype(np.float32))
    n = 200_000
    u = rng.uniform(size=n)
    choice = u * 16
    idx = np.minimum(choice.astype(np.int64), 15)
    frac = choice - np.floor(choice)
    take_alias = frac >= threshold[idx]
    sampled = np.where(take_alias, alias[idx], idx)
    freq = np.bincount(sampled, minlength=16) / n
    np.testing.assert_allclose(freq, p, atol=0.01)


def _synthetic_env(h=16, w=32, hot=(4, 7), hot_value=100.0):
    texels = np.full((h, w, 3), 0.05, np.float32)
    texels[hot[0], hot[1]] = hot_value
    return texels


def test_distribution_pdf_integrates_to_one():
    texels = _synthetic_env()
    *_ , pdf = env_ops.build_distribution(texels)
    h, w = texels.shape[:2]
    d_theta = np.pi / h
    d_phi = 2 * np.pi / w
    theta = (np.arange(h) + 0.5) * d_theta
    solid = np.sin(theta) * d_theta * d_phi
    total = (pdf * solid[:, None]).sum()
    assert total == pytest.approx(1.0, rel=1e-3)


def test_sample_environment_hits_hotspot():
    import jax.numpy as jnp
    from metal_pathtracer.schema import settings_to_uniforms, settings_to_static
    from metal_pathtracer.settings import RenderSettings
    from metal_pathtracer.ops.camera import build_camera

    texels = _synthetic_env()
    mips = env_ops.build_mips(texels)
    (ma, mt, ca, ct, pdf) = env_ops.build_distribution(texels)
    from metal_pathtracer.schema import EnvironmentSoA
    env = EnvironmentSoA(
        texels=jnp.asarray(texels), mips=tuple(jnp.asarray(m) for m in mips),
        marginal_threshold=jnp.asarray(mt),
        marginal_alias=jnp.asarray(ma.astype(np.int32)),
        conditional_threshold=jnp.asarray(ct),
        conditional_alias=jnp.asarray(ca.astype(np.int32)),
        pdf=jnp.asarray(pdf), width=32, height=16)

    settings = RenderSettings()
    cam = build_camera(settings, 8, 8)
    uniforms = settings_to_uniforms(settings, cam, 0, 0)
    static = settings_to_static(settings, 8, 8, [0])

    state = jnp.arange(4096, dtype=jnp.uint32)
    rough = jnp.ones(4096, jnp.float32)
    new_state, d, radiance, p, valid = env_ops.sample_environment(
        env, state, uniforms, static, rough)
    assert bool(valid.all())
    # Most samples should point at the hot texel's direction
    # theoretical hot-texel probability ~0.825 for this synthetic map
    hot_frac = float((np.asarray(p) > 1.0).mean())
    assert 0.78 < hot_frac < 0.88
    # Hot samples carry the hot texel's pdf and point into its texel
    hot = np.asarray(p) > 1.0
    np.testing.assert_allclose(np.asarray(p)[hot], pdf[4, 7], rtol=1e-4)
    # Directions must map back to the hot texel under the LOOKUP convention
    # (u = (atan2(z,x)+pi)/2pi), i.e. sampling and lookup are consistent.
    d_hot = np.asarray(d)[hot]
    theta = np.arccos(np.clip(d_hot[:, 1], -1, 1))
    u = (np.arctan2(d_hot[:, 2], d_hot[:, 0]) + np.pi) / (2 * np.pi)
    rows = (theta / np.pi * 16).astype(int)
    cols = (u * 32).astype(int)
    assert (rows == 4).all() and (cols == 7).all()


def test_environment_pdf_matches_table():
    import jax.numpy as jnp
    from metal_pathtracer.schema import EnvironmentSoA

    texels = _synthetic_env()
    (ma, mt, ca, ct, pdf) = env_ops.build_distribution(texels)
    env = EnvironmentSoA(
        texels=jnp.asarray(texels), mips=(),
        marginal_threshold=jnp.asarray(mt),
        marginal_alias=jnp.asarray(ma.astype(np.int32)),
        conditional_threshold=jnp.asarray(ct),
        conditional_alias=jnp.asarray(ca.astype(np.int32)),
        pdf=jnp.asarray(pdf), width=32, height=16)

    # direction of the hot texel (lookup convention): row 4, col 7
    fy = (4 + 0.5) / 16
    fx = (7 + 0.5) / 32
    theta = fy * np.pi
    phi = fx * 2 * np.pi - np.pi
    d = jnp.asarray([[np.sin(theta) * np.cos(phi), np.cos(theta),
                      np.sin(theta) * np.sin(phi)]], jnp.float32)
    got = float(np.asarray(env_ops.environment_pdf(env, d, jnp.float32(0.0)))[0])
    assert got == pytest.approx(float(pdf[4, 7]), rel=1e-3)


def test_bilinear_wrap_addressing():
    import jax.numpy as jnp
    img = jnp.asarray(np.arange(12, dtype=np.float32).reshape(2, 2, 3))
    # u=0 and u=1 must sample the same color (repeat addressing)
    c0 = env_ops._bilinear_wrap(img, jnp.asarray([0.0]), jnp.asarray([0.25]))
    c1 = env_ops._bilinear_wrap(img, jnp.asarray([1.0]), jnp.asarray([0.25]))
    np.testing.assert_allclose(np.asarray(c0), np.asarray(c1), atol=1e-6)


def test_hdr_roundtrip(tmp_path):
    """Write a flat-scanline RGBE file and read it back."""
    h, w = 4, 8
    want = np.zeros((h, w, 3), np.float32)
    want[..., 0] = 1.0
    want[2, 3] = (4.0, 2.0, 1.0)
    # encode RGBE
    rgbe = np.zeros((h, w, 4), np.uint8)
    maxc = want.max(-1)
    exp = np.ceil(np.log2(np.maximum(maxc, 1e-30))).astype(np.int32) + 1
    scale = np.ldexp(1.0, -exp + 8)
    for c in range(3):
        rgbe[..., c] = np.clip(want[..., c] * scale, 0, 255).astype(np.uint8)
    rgbe[..., 3] = (exp + 128).astype(np.uint8)
    path = tmp_path / "test.hdr"
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())
    got = env_ops.load_hdr_image(str(path))
    np.testing.assert_allclose(got, want, rtol=0.02)
