"""CarPaint BSDF: base (diffuse/conductor) + procedural flakes + clearcoat.

Vectorized port of the reference's three-lobe car paint
(reference: shaders/pathtrace.metal carpaint_*:3300-3536, sample case 6
:5508-5633, evaluate case 6 :5079-5110). Flake normals come from a spatial
hash of the hit position scaled by flakeScale — pure arithmetic, identical
here.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from metal_pathtracer.ops import rng as rng_ops
from metal_pathtracer.ops.bsdf import (
    BsdfSample,
    ClampParams,
    clamp_specular_pdf,
    clamp_specular_tail,
    fresnel_conductor,
    ggx_d,
    ggx_g1,
    ggx_pdf,
    lambert_pdf,
    material_base_color,
    plastic_coat_roughness,
    plastic_coat_f0,
    plastic_diffuse_transmission,
    plastic_specular_tint,
    sample_ggx_vndf,
    schlick_fresnel,
)
from metal_pathtracer.ops.vecmath import (
    build_onb,
    dot,
    normalize,
    reflect,
    safe_normalize,
    to_world,
    where3,
)

PI = 3.14159265358979323846


def _hash3(p):
    """(reference: pathtrace.metal carpaint_hash3)"""
    p = jnp.mod(p * 0.3183099 + jnp.asarray([0.1, 0.3, 0.7], p.dtype), 1.0)
    s = (p[..., 0] * (p[..., 1] + 33.33)
         + p[..., 1] * (p[..., 2] + 55.55)
         + p[..., 2] * (p[..., 0] + 77.77))
    p = p + s[..., None]
    v = jnp.stack([
        (p[..., 0] + p[..., 1]),
        (p[..., 0] + p[..., 2]),
        (p[..., 1] + p[..., 2])], -1) * 13.5453123
    return jnp.mod(v, 1.0)


def flake_normal(m, position, normal):
    """(reference: pathtrace.metal carpaint_flake_normal:3371-3392)"""
    scale = m.carpaint_flake_scale
    rand = _hash3(position * scale[..., None])
    anis = m.carpaint_flake_anisotropy
    ax = jnp.maximum(1.0 - anis, 1e-3)
    ay = jnp.maximum(1.0 + anis, 1e-3)
    phi = 2.0 * PI * rand[..., 0]
    r = jnp.sqrt(jnp.maximum(rand[..., 1], 1e-4))
    x = r * jnp.cos(phi) * ax
    y = r * jnp.sin(phi) * ay
    m2 = jnp.clip(x * x + y * y, 0.0, 0.99)
    z = jnp.sqrt(jnp.maximum(1.0 - m2, 0.0))
    tangent, bitangent = build_onb(normal)
    perturbed = normalize(x[..., None] * tangent + y[..., None] * bitangent
                          + z[..., None] * normal)
    strength = m.carpaint_flake_normal_strength[..., None]
    return normalize(normal + (perturbed - normal) * strength)


def _base_f0(m):
    has = m.carpaint_has_base_conductor > 0.0
    ones = jnp.ones(m.carpaint_has_base_conductor.shape, jnp.float32)
    fc = fresnel_conductor(ones, m.carpaint_base_eta, m.carpaint_base_k)
    return where3(has, fc, jnp.clip(m.base_color, 0.0, 1.0))


def _eval_coat(m, normal, wo, wi, clamp_p):
    """(reference: carpaint_eval_coat:3394-3427)"""
    cos_o = jnp.maximum(dot(normal, wo), 0.0)
    cos_i = jnp.maximum(dot(normal, wi), 0.0)
    roughness = plastic_coat_roughness(m)
    alpha = jnp.maximum(roughness * roughness, 1e-4)
    wh = safe_normalize(wo + wi)
    geo = (cos_i > 0.0) & (cos_o > 0.0) & (dot(wh, normal) > 0.0) \
        & (dot(wo, wh) > 0.0) & (dot(wi, wh) > 0.0)
    d = ggx_d(alpha, normal, wh)
    g = ggx_g1(alpha, cos_o) * ggx_g1(alpha, cos_i)
    f0 = plastic_coat_f0(m)
    f0c = jnp.broadcast_to(f0[..., None], normal.shape)
    f = schlick_fresnel(f0c, dot(wi, wh))
    spec = f * (d * g / jnp.maximum(4.0 * cos_o * cos_i, 1e-6))[..., None]
    spec = clamp_specular_tail(spec * plastic_specular_tint(m),
                               roughness, f0c, clamp_p)
    pdf_raw = ggx_pdf(alpha, normal, wo, wi)
    ok = geo & (pdf_raw > 0.0)
    pdf = jnp.where(ok, clamp_specular_pdf(pdf_raw, clamp_p), 0.0)
    return where3(ok, spec, jnp.zeros_like(spec)), pdf


def _eval_flake(m, position, normal, wo, wi, clamp_p):
    """(reference: carpaint_eval_flake:3429-3470)"""
    fn = flake_normal(m, position, normal)
    cos_o = jnp.maximum(dot(fn, wo), 0.0)
    cos_i = jnp.maximum(dot(fn, wi), 0.0)
    roughness = jnp.maximum(jnp.clip(m.carpaint_flake_roughness, 0.0, 1.0), 1e-3)
    alpha = roughness * roughness
    wh = safe_normalize(wo + wi)
    geo = (cos_i > 0.0) & (cos_o > 0.0) & (dot(wh, fn) > 0.0) \
        & (dot(wo, wh) > 0.0) & (dot(wi, wh) > 0.0)
    d = ggx_d(alpha, fn, wh)
    g = ggx_g1(alpha, cos_o) * ggx_g1(alpha, cos_i)
    f0 = _base_f0(m)
    f = schlick_fresnel(f0, dot(wi, wh))
    spec = f * (d * g / jnp.maximum(4.0 * cos_o * cos_i, 1e-6))[..., None]
    spec = clamp_specular_tail(spec * plastic_specular_tint(m),
                               roughness, f0, clamp_p)
    coat_avg = jnp.clip(m.coat_fresnel_avg, 0.0, 1.0)
    spec = spec * jnp.maximum(1.0 - coat_avg, 0.0)[..., None]
    pdf_raw = ggx_pdf(alpha, fn, wo, wi)
    ok = geo & (pdf_raw > 0.0)
    pdf = jnp.where(ok, clamp_specular_pdf(pdf_raw, clamp_p), 0.0)
    return where3(ok, spec, jnp.zeros_like(spec)), pdf


def _eval_base(m, normal, wo, wi, clamp_p):
    """(reference: carpaint_eval_base:3472-3536)"""
    cos_o = jnp.maximum(dot(normal, wo), 0.0)
    cos_i = jnp.maximum(dot(normal, wi), 0.0)
    geo = (cos_i > 0.0) & (cos_o > 0.0)

    metallic = jnp.clip(m.carpaint_base_metallic, 0.0, 1.0)
    diffuse_w = jnp.maximum(1.0 - metallic, 0.0)
    spec_w = jnp.maximum(metallic, 0.0)
    coat_avg = jnp.clip(m.coat_fresnel_avg, 0.0, 1.0)
    base_color = material_base_color(m)

    combined = jnp.zeros_like(normal)
    # diffuse lobe
    diffuse = base_color / PI
    coat_trans = plastic_diffuse_transmission(m, cos_i, cos_o)
    diffuse = diffuse * coat_trans * jnp.maximum(1.0 - coat_avg, 0.0)[..., None]
    diffuse = jnp.maximum(diffuse, 0.0)
    use_diff = diffuse_w > 1e-4
    combined = combined + jnp.where(use_diff[..., None],
                                    diffuse_w[..., None] * diffuse, 0.0)
    pdf_diffuse = jnp.where(use_diff, lambert_pdf(normal, wi), 0.0)

    # conductor/glossy lobe
    roughness = jnp.maximum(jnp.clip(m.carpaint_base_roughness, 0.0, 1.0), 1e-3)
    alpha = roughness * roughness
    wh = safe_normalize(wo + wi)
    half_ok = (dot(wh, normal) > 0.0) & (dot(wo, wh) > 0.0) & (dot(wi, wh) > 0.0)
    d = ggx_d(alpha, normal, wh)
    g = ggx_g1(alpha, cos_o) * ggx_g1(alpha, cos_i)
    has = m.carpaint_has_base_conductor > 0.0
    f0 = _base_f0(m)
    f = where3(has,
               fresnel_conductor(dot(wi, wh), m.carpaint_base_eta, m.carpaint_base_k),
               schlick_fresnel(base_color, dot(wi, wh)))
    spec = f * (d * g / jnp.maximum(4.0 * cos_o * cos_i, 1e-6))[..., None]
    spec = clamp_specular_tail(
        spec * plastic_specular_tint(m)
        * jnp.maximum(1.0 - coat_avg, 0.0)[..., None],
        roughness, f0, clamp_p)
    spec = jnp.maximum(spec, 0.0)
    use_spec = (spec_w > 1e-4) & half_ok
    combined = combined + jnp.where(use_spec[..., None],
                                    spec_w[..., None] * spec, 0.0)
    pdf_raw = ggx_pdf(alpha, normal, wo, wi)
    pdf_spec = jnp.where(use_spec & (pdf_raw > 0.0),
                         clamp_specular_pdf(pdf_raw, clamp_p), 0.0)

    any_lobe = (diffuse_w > 1e-4) | (spec_w > 1e-4)
    ok = geo & any_lobe
    f_out = where3(ok, jnp.maximum(combined, 0.0), jnp.zeros_like(combined))
    pdf = jnp.where(ok, diffuse_w * pdf_diffuse + spec_w * pdf_spec, 0.0)
    return f_out, pdf


def _lobe_probs(m):
    p_coat = jnp.clip(m.coat_sample_weight, 0.0, 0.95)
    p_flake = jnp.clip(m.carpaint_flake_sample_weight, 0.0, 0.95)
    p_base = jnp.maximum(1.0 - (p_coat + p_flake), 0.0)
    norm = p_coat + p_flake + p_base
    degenerate = norm <= 1e-6
    p_coat = jnp.where(degenerate, 0.0, p_coat)
    p_flake = jnp.where(degenerate, 0.0, p_flake)
    p_base = jnp.where(degenerate, 1.0, p_base)
    norm = jnp.where(degenerate, 1.0, norm)
    return p_coat / norm, p_flake / norm, p_base / norm


def evaluate_carpaint(m, position, normal, wo, wi, clamp_p: ClampParams):
    """(reference: evaluate_bsdf case 6)"""
    p_coat, p_flake, p_base = _lobe_probs(m)
    coat_f, coat_pdf = _eval_coat(m, normal, wo, wi, clamp_p)
    flake_f, flake_pdf = _eval_flake(m, position, normal, wo, wi, clamp_p)
    base_f, base_pdf = _eval_base(m, normal, wo, wi, clamp_p)
    value = (p_base[..., None] * base_f + p_flake[..., None] * flake_f
             + p_coat[..., None] * coat_f)
    pdf = p_base * base_pdf + p_flake * flake_pdf + p_coat * coat_pdf
    return value, pdf


def sample_carpaint(m, position, normal, wo, state, clamp_p: ClampParams,
                    specular_only: bool):
    """(reference: sample_bsdf case 6:5508-5633).

    RNG: 1 lobe selector, then coat/flake draw 2 (VNDF) and base draws
    1 (sub-lobe choose) + 2 (VNDF or cosine); per-lane state follows the
    branch taken.
    """
    shape = normal.shape[:-1]
    p_coat, p_flake, p_base = _lobe_probs(m)

    state, r = rng_ops.rand_uniform(state)
    threshold_coat = p_coat
    threshold_flake = p_coat + p_flake
    lobe = jnp.where((p_coat > 0.0) & (r < threshold_coat), 2,
                     jnp.where((p_flake > 0.0) & (r < threshold_flake), 1, 0))
    # base fallback when pBase ~ 0 (reference :5534-5541)
    base_degenerate = p_base <= 1e-6
    fallback = jnp.where((p_flake > p_coat) & (p_flake > 0.0), 1,
                         jnp.where(p_coat > 0.0, 2, 0))
    lobe = jnp.where((lobe == 0) & base_degenerate, fallback, lobe)

    coat_roughness = plastic_coat_roughness(m)
    fn = flake_normal(m, position, normal)
    flake_roughness = jnp.maximum(jnp.clip(m.carpaint_flake_roughness, 0.0, 1.0), 1e-3)

    # --- coat branch: 2 draws
    state_c, wh_c = sample_ggx_vndf(normal, wo, coat_roughness, state)
    wi_c = safe_normalize(reflect(-wo, wh_c))
    coat_ok = dot(wh_c, normal) > 0.0

    # --- flake branch: 2 draws
    state_f, wh_f = sample_ggx_vndf(fn, wo, flake_roughness, state)
    wi_f = safe_normalize(reflect(-wo, wh_f))
    flake_ok = dot(wh_f, fn) > 0.0

    # --- base branch: 1 + 2 draws
    metallic = jnp.clip(m.carpaint_base_metallic, 0.0, 1.0)
    diffuse_w = jnp.maximum(1.0 - metallic, 0.0)
    spec_w = jnp.maximum(metallic, 0.0)
    state_b, choose = rng_ops.rand_uniform(state)
    sample_spec = (spec_w > 0.0) & ((diffuse_w + spec_w) > 0.0) & \
        (choose < spec_w / jnp.maximum(diffuse_w + spec_w, 1e-6))
    base_rough = jnp.maximum(jnp.clip(m.carpaint_base_roughness, 0.0, 1.0), 1e-3)
    state_bs, wh_b = sample_ggx_vndf(normal, wo, base_rough, state_b)
    wi_bs = safe_normalize(reflect(-wo, wh_b))
    spec_ok = dot(wh_b, normal) > 0.0
    state_bd, local = rng_ops.sample_cosine_hemisphere(state_b)
    wi_bd = safe_normalize(to_world(local, normal))
    wi_b = where3(sample_spec, wi_bs, wi_bd)
    state_b_final = jnp.where(sample_spec, state_bs, state_bd)
    base_ok = jnp.where(sample_spec, spec_ok, True)

    wi = where3(lobe == 2, wi_c, where3(lobe == 1, wi_f, wi_b))
    branch_ok = jnp.where(lobe == 2, coat_ok,
                          jnp.where(lobe == 1, flake_ok, base_ok))
    new_state = jnp.where(lobe == 2, state_c,
                          jnp.where(lobe == 1, state_f, state_b_final))

    dir_ok = branch_ok & jnp.all(jnp.isfinite(wi), -1) & (dot(normal, wi) > 0.0)

    coat_f, coat_pdf = _eval_coat(m, normal, wo, wi, clamp_p)
    flake_f, flake_pdf = _eval_flake(m, position, normal, wo, wi, clamp_p)
    base_f, base_pdf = _eval_base(m, normal, wo, wi, clamp_p)
    combined_pdf = p_base * base_pdf + p_flake * flake_pdf + p_coat * coat_pdf

    sel_f = where3(lobe == 2, coat_f, where3(lobe == 1, flake_f, base_f))
    sel_pdf = jnp.where(lobe == 2, coat_pdf,
                        jnp.where(lobe == 1, flake_pdf, base_pdf))
    cos_i = jnp.maximum(dot(normal, wi), 0.0)
    weight = sel_f * (cos_i / jnp.maximum(combined_pdf, 1e-20))[..., None]

    ok = (dir_ok & (combined_pdf > 0.0) & (sel_pdf > 0.0)
          & jnp.any(sel_f > 0.0, -1) & (cos_i > 0.0)
          & jnp.all(jnp.isfinite(weight), -1))
    if specular_only:
        # specularOnly has no carve-out in the reference case 6; keep as-is.
        pass

    lobe_type = jnp.where((lobe == 0) & jnp.logical_not(sample_spec), 0, 1)
    lobe_roughness = jnp.where(
        lobe == 2, coat_roughness,
        jnp.where(lobe == 1, flake_roughness,
                  jnp.where(sample_spec, base_rough, 1.0)))

    out = BsdfSample.invalid(shape)
    out = out.replace(
        direction=where3(ok, wi, out.direction),
        weight=where3(ok, jnp.maximum(weight, 0.0), out.weight),
        pdf=jnp.where(ok, combined_pdf, 0.0),
        directional_pdf=jnp.where(ok, jnp.maximum(sel_pdf, 0.0), 0.0),
        lobe_type=jnp.where(ok, lobe_type, 0),
        lobe_roughness=jnp.where(ok, lobe_roughness, 0.0))
    return new_state, out
