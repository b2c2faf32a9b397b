"""BSDF unit tests: white furnace, sample/eval consistency, Fresnel laws.

The reference ships no BSDF tests (SURVEY.md §4 gap list); these validate
the ported lobes against analytic expectations.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from metal_pathtracer import constants as C
from metal_pathtracer.ops import bsdf as bsdf_ops
from metal_pathtracer.scene.resources import Material, SceneResources


def make_lanes(material: Material, n: int):
    res = SceneResources()
    res.add_material(material)
    soa = res.build_materials_soa()
    return bsdf_ops.gather_material(soa, jnp.zeros(n, jnp.int32))


def default_clamp():
    """Firefly clamps disabled for analytic tests."""
    z = jnp.float32(0.0)
    return bsdf_ops.ClampParams(
        clamp_factor=z, clamp_floor=z, throughput_clamp=z,
        specular_tail_base=z, specular_tail_roughness_scale=z,
        min_specular_pdf=z, max_contribution=z, enabled=z)


N = 1 << 14
NORMAL = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0]), (N, 3))
POS = jnp.zeros((N, 3))


def run_sample(material, wo_z=0.7, types=None, sss_mode=0):
    m = make_lanes(material, N)
    wo = jnp.broadcast_to(
        jnp.asarray([np.sqrt(1 - wo_z ** 2), 0.0, wo_z], jnp.float32), (N, 3))
    incident = -wo
    state = jnp.arange(N, dtype=jnp.uint32) * jnp.uint32(2654435761)
    types = types or [material.mat_type]
    state, smp = bsdf_ops.sample_bsdf(
        m, POS, NORMAL, wo, incident, jnp.ones(N, bool), state,
        default_clamp(), sss_mode, jnp.ones(N, jnp.float32), False, types)
    return m, wo, smp


def test_lambert_furnace():
    """E[weight] == albedo for cosine-sampled lambert."""
    mat = Material(base_color=(0.6, 0.7, 0.8), mat_type=C.MATERIAL_LAMBERTIAN)
    _, _, smp = run_sample(mat)
    mean_w = np.asarray(smp.weight).mean(0)
    np.testing.assert_allclose(mean_w, [0.6, 0.7, 0.8], atol=0.01)


def test_lambert_pdf_is_cosine():
    mat = Material(base_color=(1.0, 1.0, 1.0), mat_type=C.MATERIAL_LAMBERTIAN)
    _, _, smp = run_sample(mat)
    d = np.asarray(smp.direction)
    pdf = np.asarray(smp.pdf)
    np.testing.assert_allclose(pdf, np.maximum(d[:, 2], 0) / np.pi, atol=1e-5)


def test_metal_rough_furnace_reference_parity():
    """Documented reference quirk: the rough conductor pairs Heitz VNDF
    *sampling* with the reference's `ggx_pdf` = D*G1*cosH/(4 wo.wh)
    (reference: pathtrace.metal:3727-3742), which is NOT the VNDF density
    D*G1/(4 cosO); the estimator over-weights tilted half-vectors and the
    white-furnace mean exceeds 1 (~1.4 at roughness 0.4, f0=0.9). Both
    reference backends share the formulas, so we replicate rather than fix.
    This test pins the behavior so any change is deliberate."""
    mat = Material(base_color=(0.9, 0.9, 0.9), roughness=0.4,
                   mat_type=C.MATERIAL_METAL)
    _, _, smp = run_sample(mat)
    w = np.asarray(smp.weight)
    valid = np.asarray(smp.pdf) > 0
    mean_w = w[valid].mean(0)
    assert 1.2 < mean_w[0] < 1.7
    assert (w[valid] >= 0).all()


def test_metal_smooth_is_mirror():
    mat = Material(base_color=(1.0, 1.0, 1.0), roughness=0.0,
                   mat_type=C.MATERIAL_METAL)
    _, wo, smp = run_sample(mat, wo_z=0.5)
    assert bool(np.asarray(smp.is_delta).all())
    d = np.asarray(smp.direction)
    want = np.asarray(bsdf_ops.reflect(-wo, NORMAL))
    np.testing.assert_allclose(d, want, atol=1e-6)


def test_metal_sample_eval_consistency():
    """eval(sampled wi) must reproduce weight = f*cos/pdf."""
    mat = Material(base_color=(0.8, 0.6, 0.4), roughness=0.5,
                   mat_type=C.MATERIAL_METAL)
    m, wo, smp = run_sample(mat)
    ev = bsdf_ops.evaluate_bsdf(
        m, POS, NORMAL, wo, smp.direction, default_clamp(), 0,
        jnp.ones(N, jnp.float32), False, [C.MATERIAL_METAL])
    valid = (np.asarray(smp.pdf) > 0) & (np.asarray(ev.pdf) > 0)
    cos_i = np.asarray(smp.direction)[:, 2]
    w_from_eval = (np.asarray(ev.value) * cos_i[:, None]
                   / np.asarray(ev.pdf)[:, None])
    np.testing.assert_allclose(w_from_eval[valid], np.asarray(smp.weight)[valid],
                               rtol=2e-3, atol=1e-4)
    np.testing.assert_allclose(np.asarray(ev.pdf)[valid],
                               np.asarray(smp.pdf)[valid], rtol=2e-3)


def test_dielectric_snell_and_tir():
    mat = Material(base_color=(1, 1, 1), mat_type=C.MATERIAL_DIELECTRIC, ior=1.5)
    _, wo, smp = run_sample(mat, wo_z=0.7)
    assert bool(np.asarray(smp.is_delta).all())
    d = np.asarray(smp.direction)
    refracted = d[:, 2] < 0
    # Snell: sin_t = sin_i / 1.5 for refracted lanes
    sin_i = np.sqrt(1 - 0.7 ** 2)
    sin_t = np.linalg.norm(d[refracted][:, :2], axis=-1)
    np.testing.assert_allclose(sin_t, sin_i / 1.5, atol=1e-5)
    # refracted lanes enter the medium
    assert (np.asarray(smp.medium_event)[refracted] == 1).all()
    assert (np.asarray(smp.medium_event)[~refracted] == 0).all()
    # reflection weight equals Fresnel (the reference's convention)
    fr, _ = bsdf_ops.fresnel_dielectric_exact(
        jnp.float32(0.7), jnp.float32(1.0), jnp.float32(1.5))
    np.testing.assert_allclose(np.asarray(smp.weight)[~refracted][:, 0],
                               float(fr), atol=1e-5)


def test_thin_dielectric_no_medium_event():
    mat = Material(base_color=(1, 1, 1), mat_type=C.MATERIAL_DIELECTRIC,
                   ior=1.5, thin=True)
    _, _, smp = run_sample(mat)
    assert (np.asarray(smp.medium_event) == 0).all()


def test_plastic_energy_bounded():
    mat = Material(base_color=(0.5, 0.1, 0.1), mat_type=C.MATERIAL_PLASTIC,
                   coat_roughness=0.1, coat_ior=1.5)
    _, _, smp = run_sample(mat)
    valid = np.asarray(smp.pdf) > 0
    assert valid.mean() > 0.9
    mean_w = np.asarray(smp.weight)[valid].mean(0)
    assert (mean_w <= 1.05).all()
    assert mean_w[0] > mean_w[1]  # red-dominant base shows through


def test_plastic_sample_eval_consistency():
    mat = Material(base_color=(0.4, 0.5, 0.6), mat_type=C.MATERIAL_PLASTIC,
                   coat_roughness=0.3, coat_ior=1.5)
    m, wo, smp = run_sample(mat)
    ev = bsdf_ops.evaluate_bsdf(
        m, POS, NORMAL, wo, smp.direction, default_clamp(), 0,
        jnp.ones(N, jnp.float32), False, [C.MATERIAL_PLASTIC])
    valid = (np.asarray(smp.pdf) > 0) & (np.asarray(ev.pdf) > 0)
    np.testing.assert_allclose(np.asarray(ev.pdf)[valid],
                               np.asarray(smp.pdf)[valid], rtol=2e-3)


def test_carpaint_samples_valid():
    mat = Material(base_color=(0.7, 0.1, 0.1), mat_type=C.MATERIAL_CARPAINT,
                   carpaint_base_metallic=0.3, carpaint_base_roughness=0.2,
                   carpaint_flake_sample_weight=0.2,
                   carpaint_flake_roughness=0.15,
                   carpaint_flake_scale=0.5,
                   carpaint_flake_normal_strength=0.35,
                   coat_roughness=0.04, coat_ior=1.5)
    _, _, smp = run_sample(mat, types=[C.MATERIAL_CARPAINT])
    valid = np.asarray(smp.pdf) > 0
    assert valid.mean() > 0.5
    d = np.asarray(smp.direction)[valid]
    assert (d[:, 2] > 0).all()
    assert (np.asarray(smp.weight)[valid] >= 0).all()


def test_carpaint_sample_eval_consistency():
    mat = Material(base_color=(0.7, 0.1, 0.1), mat_type=C.MATERIAL_CARPAINT,
                   carpaint_base_metallic=0.0, carpaint_base_roughness=0.3,
                   carpaint_flake_sample_weight=0.0,
                   coat_roughness=0.2, coat_ior=1.5)
    m, wo, smp = run_sample(mat, types=[C.MATERIAL_CARPAINT])
    from metal_pathtracer.ops import carpaint as cp
    value, pdf = cp.evaluate_carpaint(m, POS, NORMAL, wo, smp.direction,
                                      default_clamp())
    valid = (np.asarray(smp.pdf) > 0) & (np.asarray(pdf) > 0)
    assert valid.mean() > 0.8
    np.testing.assert_allclose(np.asarray(pdf)[valid],
                               np.asarray(smp.pdf)[valid], rtol=2e-3)


def test_pbr_opaque_furnace_bounded():
    mat = Material(base_color=(0.8, 0.8, 0.8), roughness=0.5,
                   mat_type=C.MATERIAL_PBR, pbr_metallic=0.0, ior=1.5)
    _, _, smp = run_sample(mat, types=[C.MATERIAL_PBR])
    valid = np.asarray(smp.pdf) > 0
    assert valid.mean() > 0.9
    mean_w = np.asarray(smp.weight)[valid].mean(0)
    assert (mean_w < 1.05).all() and mean_w[0] > 0.4


def test_pbr_metallic_behaves_like_conductor():
    mat = Material(base_color=(0.9, 0.5, 0.3), roughness=0.3,
                   mat_type=C.MATERIAL_PBR, pbr_metallic=1.0, ior=1.5)
    _, _, smp = run_sample(mat, types=[C.MATERIAL_PBR])
    valid = np.asarray(smp.pdf) > 0
    mean_w = np.asarray(smp.weight)[valid].mean(0)
    # tinted reflection: channel ordering follows base color
    assert mean_w[0] > mean_w[1] > mean_w[2]


def test_pbr_transmission_refracts():
    mat = Material(base_color=(1, 1, 1), roughness=0.05,
                   mat_type=C.MATERIAL_PBR, pbr_metallic=0.0,
                   pbr_transmission=1.0, ior=1.5)
    _, _, smp = run_sample(mat, types=[C.MATERIAL_PBR])
    valid = np.asarray(smp.pdf) > 0
    d = np.asarray(smp.direction)[valid]
    frac_trans = (d[:, 2] < 0).mean()
    assert frac_trans > 0.5  # mostly transmission at normal-ish incidence


def test_pbr_sample_eval_pdf_relationship():
    """Reference behavior: sample_pbr reports only the CHOSEN lobe's
    mixture term (pLobe*pdfLobe, reference: pathtrace.metal:4818-4827,
    4936-4940) while evaluate_pbr mixes spec+diffuse pdfs (:4706-4710) —
    so eval.pdf >= sample.pdf on reflection lanes, with equality when the
    other lobe's pdf vanishes."""
    mat = Material(base_color=(0.6, 0.7, 0.8), roughness=0.4,
                   mat_type=C.MATERIAL_PBR, pbr_metallic=0.3, ior=1.5)
    m, wo, smp = run_sample(mat, types=[C.MATERIAL_PBR])
    from metal_pathtracer.ops import pbr as pbr_ops
    ev = pbr_ops.evaluate_pbr(m, NORMAL, wo, smp.direction, default_clamp(),
                              jnp.ones(N, jnp.float32), False)
    valid = (np.asarray(smp.pdf) > 0) & (np.asarray(ev.pdf) > 0) \
        & ~np.asarray(smp.is_delta)
    assert valid.mean() > 0.8
    assert (np.asarray(ev.pdf)[valid] >= np.asarray(smp.pdf)[valid] * 0.999).all()


def test_sss_separable_has_exit_point():
    mat = Material(base_color=(0.8, 0.4, 0.2), mat_type=C.MATERIAL_SUBSURFACE,
                   sss_mfp=0.5, coat_ior=1.5)
    _, _, smp = run_sample(mat, types=[C.MATERIAL_SUBSURFACE], sss_mode=1)
    valid = np.asarray(smp.pdf) > 0
    assert valid.mean() > 0.9
    assert np.asarray(smp.is_bssrdf)[valid].all()
    assert np.asarray(smp.has_exit_point)[valid].all()
    # exit points displaced laterally from the entry point
    r = np.linalg.norm(np.asarray(smp.exit_point)[valid][:, :2], axis=-1)
    assert r.mean() > 0.01


def test_sss_mode_off_falls_back_to_lambert():
    mat = Material(base_color=(0.8, 0.4, 0.2), mat_type=C.MATERIAL_SUBSURFACE,
                   sss_mfp=0.5)
    _, _, smp = run_sample(mat, types=[C.MATERIAL_SUBSURFACE], sss_mode=0)
    valid = np.asarray(smp.pdf) > 0
    mean_w = np.asarray(smp.weight)[valid].mean(0)
    np.testing.assert_allclose(mean_w, [0.8, 0.4, 0.2], atol=0.02)
    assert not np.asarray(smp.is_bssrdf).any()


def test_rng_stream_isolation_between_types():
    """Two materials in one wavefront advance their RNG independently per
    the branch taken (the vectorized analogue of the reference's per-thread
    switch)."""
    res = SceneResources()
    res.add_material(Material(base_color=(0.5, 0.5, 0.5),
                              mat_type=C.MATERIAL_LAMBERTIAN))
    res.add_material(Material(base_color=(1, 1, 1),
                              mat_type=C.MATERIAL_DIELECTRIC, ior=1.5))
    soa = res.build_materials_soa()
    n = 64
    idx = jnp.asarray(np.arange(n) % 2, jnp.int32)
    m = bsdf_ops.gather_material(soa, idx)
    wo = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0], jnp.float32), (n, 3))
    state0 = jnp.full((n,), 12345, jnp.uint32)
    state, smp = bsdf_ops.sample_bsdf(
        m, jnp.zeros((n, 3)), wo, wo, -wo, jnp.ones(n, bool), state0,
        default_clamp(), 0, jnp.ones(n, jnp.float32), False,
        [C.MATERIAL_LAMBERTIAN, C.MATERIAL_DIELECTRIC])
    s = np.asarray(state)
    # lambert lanes drew 2, dielectric lanes drew 1 -> different states
    assert (s[0::2] == s[0]).all() and (s[1::2] == s[1]).all()
    assert s[0] != s[1]


@pytest.mark.parametrize("roughness", [0.02, 0.05, 0.3])
def test_ggx_d_keeps_precision_near_the_normal(roughness):
    """A smooth lobe puts its half vectors within a few float32 ulps of
    the normal, where 1 - cos^2 has no significant digits; D must still
    match a float64 evaluation (it now takes 1 - cos^2 as |n x h|^2)."""
    alpha = roughness * roughness
    theta = np.linspace(0.0, 4.0 * alpha, 33)
    phi = np.linspace(0.0, 2.0 * np.pi, 33)
    n = np.array([0.3, 0.5, -0.8])
    n /= np.linalg.norm(n)
    t = np.cross(n, [0.0, 0.0, 1.0])
    t /= np.linalg.norm(t)
    b = np.cross(n, t)
    h = (np.cos(theta)[:, None] * n
         + np.sin(theta)[:, None] * (np.cos(phi)[:, None] * t
                                     + np.sin(phi)[:, None] * b))
    h32, n32 = h.astype(np.float32), np.broadcast_to(n, h.shape)
    h64 = h32.astype(np.float64)
    h64 /= np.linalg.norm(h64, axis=-1, keepdims=True)
    c = h64 @ n
    s2 = np.sum(np.cross(n, h64) ** 2, -1)
    want = alpha ** 2 / (np.pi * (s2 + c * c * alpha ** 2) ** 2)
    got = np.asarray(bsdf_ops.ggx_d(
        jnp.float32(alpha), jnp.asarray(n32, jnp.float32), jnp.asarray(h32)))
    np.testing.assert_allclose(got, want, rtol=2e-3)
