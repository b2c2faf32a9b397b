"""glTF PBR metallic-roughness BSDF with rough transmission.

Vectorized port of the reference's PBR lobes
(reference: shaders/pathtrace.metal evaluate_pbr_metallic_roughness
:4632-4766 and sample_pbr_metallic_roughness:4768-4945): metallic/dielectric
specular with DFG energy compensation, lambert diffuse, and GGX microfacet
refraction for KHR_materials_transmission with Beer-Lambert volume tint.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from metal_pathtracer.ops import rng as rng_ops
from metal_pathtracer.ops.bsdf import (
    BsdfEval,
    BsdfSample,
    ClampParams,
    clamp_specular_pdf,
    clamp_specular_tail,
    fresnel_dielectric_exact,
    ggx_d,
    ggx_g1,
    ggx_pdf,
    lambert_pdf,
    sample_ggx_vndf,
    schlick_fresnel,
    specular_energy_compensation,
)
from metal_pathtracer.ops.vecmath import (
    dot,
    reflect,
    refract,
    safe_normalize,
    to_world,
    where3,
)

PI = 3.14159265358979323846


def dielectric_f0_from_ior(ior):
    eta = jnp.maximum(ior, 1.0)
    ratio = (eta - 1.0) / jnp.maximum(eta + 1.0, 1e-6)
    return jnp.clip(ratio * ratio, 0.0, 0.99)


def pbr_specular_weight(f0):
    return jnp.clip(jnp.max(f0, -1), 0.05, 0.95)


def transmission_tint(m, cos_theta):
    """(reference: pathtrace.metal transmission_tint)"""
    thickness = jnp.maximum(m.pbr_thickness, 0.0)
    sigma_a = jnp.maximum(m.dielectric_sigma_a, 0.0)
    distance = thickness / jnp.maximum(jnp.abs(cos_theta), 1e-3)
    tint = jnp.clip(jnp.exp(-sigma_a * distance[..., None]), 0.0, 1.0)
    skip = (thickness <= 0.0) | jnp.all(sigma_a <= 0.0, -1)
    return jnp.where(skip[..., None], 1.0, tint)


def ggx_vndf_pdf(alpha, normal, wo, wh):
    cos_o = dot(normal, wo)
    cos_h = dot(normal, wh)
    d = ggx_d(alpha, normal, wh)
    g1 = ggx_g1(alpha, cos_o)
    pdf = d * g1 * cos_h / jnp.maximum(dot(wo, wh), 1e-6)
    return jnp.where((cos_o <= 0.0) | (cos_h <= 0.0), 0.0, pdf)


def _lobe_params(m, diffuse_occlusion, specular_only):
    base_color = jnp.clip(m.base_color, 0.0, 1.0)
    metallic = jnp.clip(m.pbr_metallic, 0.0, 1.0)
    roughness = jnp.clip(m.roughness, 0.0, 1.0)
    f0 = (dielectric_f0_from_ior(m.eta)[..., None]
          + (base_color - dielectric_f0_from_ior(m.eta)[..., None])
          * metallic[..., None])
    diffuse_color = base_color * (1.0 - metallic)[..., None]
    diffuse_color = diffuse_color * jnp.clip(diffuse_occlusion, 0.0, 1.0)[..., None]
    if specular_only:
        diffuse_color = jnp.zeros_like(diffuse_color)

    transmission = jnp.clip(m.pbr_transmission, 0.0, 1.0) * (1.0 - metallic)
    reflect_scale = 1.0 - transmission
    spec_weight_base = jnp.ones_like(metallic) if specular_only \
        else pbr_specular_weight(f0)
    w_spec = spec_weight_base * reflect_scale
    w_diff = jnp.zeros_like(w_spec) if specular_only \
        else (1.0 - spec_weight_base) * reflect_scale
    w_trans = transmission
    weight_sum = w_spec + w_diff + w_trans
    safe = jnp.maximum(weight_sum, 1e-20)
    return (base_color, metallic, roughness, f0, diffuse_color, transmission,
            reflect_scale, w_spec / safe, w_diff / safe, w_trans / safe,
            weight_sum > 0.0)


def evaluate_pbr(m, normal, wo, wi, clamp_p: ClampParams,
                 diffuse_occlusion, specular_only: bool) -> BsdfEval:
    """(reference: evaluate_pbr_metallic_roughness:4632-4766)"""
    shape = normal.shape[:-1]
    cos_o = dot(normal, wo)
    cos_i = dot(normal, wi)
    abs_o = jnp.abs(cos_o)
    abs_i = jnp.abs(cos_i)
    geom_ok = (abs_o > 0.0) & (abs_i > 0.0)

    (_, _, roughness, f0, diffuse_color, transmission, reflect_scale,
     p_spec, p_diff, p_trans, weights_ok) = _lobe_params(
        m, diffuse_occlusion, specular_only)
    is_delta = (m.mat_type == 7) & (roughness <= 1e-3)

    # --- reflection side (cosO*cosI > 0, both positive)
    refl_side = (cos_o * cos_i > 0.0) & (cos_o > 0.0) & (cos_i > 0.0)
    alpha = jnp.maximum(roughness * roughness, 1e-4)
    wh = safe_normalize(wo + wi)
    half_ok = (dot(wh, normal) > 0.0) & (dot(wo, wh) > 0.0) & (dot(wi, wh) > 0.0)
    d = ggx_d(alpha, normal, wh)
    g = ggx_g1(alpha, cos_o) * ggx_g1(alpha, cos_i)
    f = schlick_fresnel(f0, dot(wi, wh))
    spec = f * (d * g / jnp.maximum(4.0 * cos_o * cos_i, 1e-6))[..., None]
    spec = spec * specular_energy_compensation(f0, roughness, abs_o)
    spec = clamp_specular_tail(spec, roughness, f0, clamp_p)
    spec = spec * reflect_scale[..., None]
    pdf_spec = ggx_pdf(alpha, normal, wo, wi)
    diffuse = (diffuse_color / PI) * reflect_scale[..., None]
    pdf_diffuse = lambert_pdf(normal, wi)
    pdf_refl = p_spec * pdf_spec + p_diff * pdf_diffuse
    refl_ok = refl_side & half_ok & (pdf_refl > 0.0)
    value_refl = jnp.maximum(spec + diffuse, 0.0)
    pdf_refl_c = clamp_specular_pdf(pdf_refl, clamp_p)

    # --- transmission side (opposite hemispheres)
    eta_t0 = jnp.maximum(m.eta, 1.0)
    inside = cos_o < 0.0
    eta_i = jnp.where(inside, eta_t0, 1.0)
    eta_t = jnp.where(inside, 1.0, eta_t0)
    eta = eta_i / eta_t
    wht = safe_normalize(wo + wi * eta[..., None])
    wht = jnp.where((dot(wht, normal) <= 0.0)[..., None], -wht, wht)
    cos_o_wh = dot(wo, wht)
    cos_i_wh = dot(wi, wht)
    dt = ggx_d(alpha, normal, wht, clamp_negative=True)
    gt = ggx_g1(alpha, abs_o) * ggx_g1(alpha, abs_i)
    fr, _ = fresnel_dielectric_exact(cos_o_wh, eta_i, eta_t)
    denom = cos_o_wh + eta * cos_i_wh
    denom_sq = denom * denom
    factor = (eta * eta) * jnp.abs(cos_i_wh) * jnp.abs(cos_o_wh)
    factor = factor / jnp.maximum(abs_o * abs_i * denom_sq, 1e-6)
    ft = ((1.0 - fr) * dt * gt * factor)[..., None]
    ft = ft * transmission_tint(m, abs_i)
    ft = ft * transmission[..., None]
    pdf_wh = ggx_vndf_pdf(alpha, normal, wo, wht)
    dwh_dwi = jnp.abs((eta * eta * cos_i_wh) / jnp.maximum(denom_sq, 1e-8))
    pdf_trans = p_trans * pdf_wh * dwh_dwi
    trans_ok = ((cos_o * cos_i <= 0.0) & (transmission > 0.0)
                & jnp.all(jnp.isfinite(wht), -1) & (dot(wht, wht) > 0.0)
                & (cos_o_wh * cos_i_wh <= 0.0)
                & (jnp.abs(denom_sq) > 1e-8) & (pdf_trans > 0.0))
    value_trans = jnp.maximum(ft, 0.0)
    pdf_trans_c = clamp_specular_pdf(pdf_trans, clamp_p)

    value = jnp.zeros(shape + (3,), jnp.float32)
    pdf = jnp.zeros(shape, jnp.float32)
    take_refl = geom_ok & weights_ok & refl_ok & jnp.logical_not(is_delta)
    take_trans = geom_ok & weights_ok & (cos_o * cos_i <= 0.0) & trans_ok \
        & jnp.logical_not(is_delta)
    value = where3(take_refl, value_refl, value)
    pdf = jnp.where(take_refl, pdf_refl_c, pdf)
    value = where3(take_trans, value_trans, value)
    pdf = jnp.where(take_trans, pdf_trans_c, pdf)
    return BsdfEval(value=value, pdf=pdf, directional_pdf=pdf,
                    is_delta=is_delta,
                    is_bssrdf=jnp.zeros(shape, bool))


def sample_pbr(m, normal, wo, incident, state, clamp_p: ClampParams,
               diffuse_occlusion, specular_only: bool):
    """(reference: sample_pbr_metallic_roughness:4768-4945).

    RNG: 1 lobe selector; smooth spec/trans draw 0 more, rough lobes draw 2.
    """
    shape = normal.shape[:-1]
    (_, _, roughness, f0, diffuse_color, transmission, reflect_scale,
     p_spec, p_diff, p_trans, weights_ok) = _lobe_params(
        m, diffuse_occlusion, specular_only)
    smooth = roughness <= 1e-3
    alpha = jnp.maximum(roughness * roughness, 1e-4)

    state, choose = rng_ops.rand_uniform(state)
    lobe_spec = choose < p_spec
    lobe_diff = jnp.logical_and(~lobe_spec, choose < p_spec + p_diff)
    lobe_trans = ~(lobe_spec | lobe_diff)

    cos_o = dot(normal, wo)
    abs_o = jnp.abs(cos_o)

    # --- specular branch
    # smooth: mirror, 0 draws
    wi_sm = reflect(incident, normal)
    f_sm = schlick_fresnel(f0, jnp.maximum(cos_o, 0.0)) * reflect_scale[..., None]
    ok_sm = dot(normal, wi_sm) > 0.0
    # rough: VNDF, 2 draws
    state_sr, wh = sample_ggx_vndf(normal, wo, roughness, state)
    wi_sr = reflect(-wo, wh)
    cos_i_sr = dot(normal, wi_sr)
    d = ggx_d(alpha, normal, wh)
    g = ggx_g1(alpha, jnp.maximum(cos_o, 0.0)) * ggx_g1(alpha, cos_i_sr)
    f_sr = schlick_fresnel(f0, dot(wi_sr, wh))
    f_sr = f_sr * (d * g / jnp.maximum(4.0 * jnp.maximum(cos_o, 0.0) * cos_i_sr,
                                       1e-6))[..., None]
    f_sr = f_sr * specular_energy_compensation(f0, roughness, jnp.maximum(cos_o, 0.0))
    f_sr = clamp_specular_tail(f_sr, roughness, f0, clamp_p)
    f_sr = f_sr * reflect_scale[..., None]
    pdf_spec_r = ggx_pdf(alpha, normal, wo, wi_sr)
    ok_sr = cos_i_sr > 0.0

    wi_s = where3(smooth, wi_sm, wi_sr)
    f_s = where3(smooth, f_sm, f_sr)
    pdf_spec = jnp.where(smooth, 1.0, pdf_spec_r)
    ok_s = jnp.where(smooth, ok_sm, ok_sr)
    state_s = jnp.where(smooth, state, state_sr)
    delta_s = smooth

    # --- diffuse branch: 2 draws
    state_d, local = rng_ops.sample_cosine_hemisphere(state)
    wi_d = safe_normalize(to_world(local, normal))
    cos_i_d = dot(normal, wi_d)
    f_d = (diffuse_color / PI) * reflect_scale[..., None]
    pdf_diffuse = lambert_pdf(normal, wi_d)
    ok_d = cos_i_d > 0.0

    # --- transmission branch
    eta_t0 = jnp.maximum(m.eta, 1.0)
    inside = cos_o < 0.0
    eta_i = jnp.where(inside, eta_t0, 1.0)
    eta_t = jnp.where(inside, 1.0, eta_t0)
    eta = eta_i / eta_t
    # smooth: 0 draws
    wi_t0 = refract(-wo, normal, eta[..., None])
    len2_t0 = dot(wi_t0, wi_t0)
    wi_t0n = wi_t0 * jax.lax.rsqrt(jnp.maximum(len2_t0, 1e-38))[..., None]
    fr0, cos_t0 = fresnel_dielectric_exact(cos_o, eta_i, eta_t)
    eta_scale = (eta_t * eta_t) / (eta_i * eta_i)
    dir_scale = eta_scale * (jnp.abs(cos_t0) / jnp.maximum(abs_o, 1e-6))
    ft0 = (jnp.maximum(1.0 - fr0, 0.0) * dir_scale)[..., None]
    ft0 = ft0 * transmission_tint(m, jnp.abs(dot(normal, wi_t0n)))
    f_t0 = transmission[..., None] * ft0
    ok_t0 = len2_t0 > 0.0
    # rough: 2 draws
    state_tr, wh_t = sample_ggx_vndf(normal, wo, roughness, state)
    wi_tr = refract(-wo, wh_t, eta[..., None])
    len2_tr = dot(wi_tr, wi_tr)
    wi_trn = wi_tr * jax.lax.rsqrt(jnp.maximum(len2_tr, 1e-38))[..., None]
    cos_i_tr = dot(normal, wi_trn)
    abs_i_tr = jnp.abs(cos_i_tr)
    cos_o_wh = dot(wo, wh_t)
    cos_i_wh = dot(wi_trn, wh_t)
    dt = ggx_d(alpha, normal, wh_t, clamp_negative=True)
    gt = ggx_g1(alpha, abs_o) * ggx_g1(alpha, abs_i_tr)
    frt, _ = fresnel_dielectric_exact(cos_o_wh, eta_i, eta_t)
    denom = cos_o_wh + eta * cos_i_wh
    denom_sq = denom * denom
    factor = (eta * eta) * jnp.abs(cos_i_wh) * jnp.abs(cos_o_wh)
    factor = factor / jnp.maximum(abs_o * abs_i_tr * denom_sq, 1e-6)
    ftr = ((1.0 - frt) * dt * gt * factor)[..., None]
    ftr = ftr * transmission_tint(m, abs_i_tr)
    f_tr = transmission[..., None] * ftr
    pdf_wh = ggx_vndf_pdf(alpha, normal, wo, wh_t)
    dwh_dwi = jnp.abs((eta * eta * cos_i_wh) / jnp.maximum(denom_sq, 1e-8))
    pdf_trans_r = pdf_wh * dwh_dwi
    ok_tr = ((len2_tr > 0.0) & (cos_i_tr * cos_o < 0.0)
             & (cos_o_wh * cos_i_wh <= 0.0) & (jnp.abs(denom_sq) > 1e-8))

    wi_t = where3(smooth, wi_t0n, wi_trn)
    f_t = where3(smooth, f_t0, f_tr)
    pdf_trans = jnp.where(smooth, 1.0, pdf_trans_r)
    ok_t = jnp.where(smooth, ok_t0, ok_tr)
    state_t = jnp.where(smooth, state, state_tr)
    delta_t = smooth

    # --- select branch per lane
    wi = where3(lobe_spec, wi_s, where3(lobe_diff, wi_d, wi_t))
    f = where3(lobe_spec, f_s, where3(lobe_diff, f_d, f_t))
    branch_ok = jnp.where(lobe_spec, ok_s,
                          jnp.where(lobe_diff, ok_d, ok_t))
    new_state = jnp.where(lobe_spec, state_s,
                          jnp.where(lobe_diff, state_d, state_t))
    is_delta = jnp.where(lobe_spec, delta_s,
                         jnp.where(lobe_diff, False, delta_t))
    pdf_spec_sel = jnp.where(lobe_spec, pdf_spec, 0.0)
    pdf_diff_sel = jnp.where(lobe_diff, pdf_diffuse, 0.0)
    pdf_trans_sel = jnp.where(lobe_trans, pdf_trans, 0.0)
    pdf = p_spec * pdf_spec_sel + p_diff * pdf_diff_sel + p_trans * pdf_trans_sel

    cos_i = dot(normal, wi)
    abs_i = jnp.abs(cos_i)
    weight = jnp.maximum(f * (abs_i / jnp.maximum(pdf, 1e-20))[..., None], 0.0)
    ok = weights_ok & branch_ok & (abs_i > 0.0) & (pdf > 0.0) \
        & jnp.all(jnp.isfinite(weight), -1)

    lobe_type = jnp.where(lobe_spec, 1, jnp.where(lobe_diff, 0, 2))
    lobe_roughness = jnp.where(lobe_diff, 1.0, roughness)

    out = BsdfSample.invalid(shape)
    out = out.replace(
        direction=where3(ok, wi, out.direction),
        weight=where3(ok, weight, out.weight),
        pdf=jnp.where(ok, pdf, 0.0),
        directional_pdf=jnp.where(ok, pdf, 0.0),
        is_delta=jnp.where(ok, is_delta, False),
        lobe_type=jnp.where(ok, lobe_type, 0),
        lobe_roughness=jnp.where(ok, lobe_roughness, 0.0))
    return new_state, out
