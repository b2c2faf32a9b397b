"""Subsurface scattering: separable (normalized-diffusion) BSSRDF and
volumetric random walk.

Vectorized port of the reference's SSS stack
(reference: shaders/pathtrace.metal sss_* helpers:3912-4059, separable
sample in case 5 :5420-5508, random walk
sample_sss_random_walk_software:4060-4310).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from metal_pathtracer import constants as C
from metal_pathtracer.ops import rng as rng_ops
from metal_pathtracer.ops.bsdf import (
    BsdfSample,
    ClampParams,
    clamp_specular_pdf,
    clamp_specular_tail,
    fresnel_dielectric_exact,
    ggx_d,
    ggx_g1,
    ggx_pdf,
    lambert_pdf,
    material_base_color,
    plastic_coat_f0,
    plastic_coat_roughness,
    plastic_specular_tint,
    sample_ggx_vndf,
    schlick_fresnel,
    schlick_fresnel_scalar,
)
from metal_pathtracer.ops.vecmath import (
    build_onb,
    dot,
    luminance,
    reflect,
    refract,
    safe_normalize,
    to_world,
    where3,
)

PI = 3.14159265358979323846
SSS_THROUGHPUT_CUTOFF = 1e-3  # (reference: pathtrace.metal:31)


def sss_sigma_a(m, base_color, mean_free_path, anisotropy):
    """(reference: pathtrace.metal sss_sigma_a:3916-3931)"""
    sigma_t = 1.0 / jnp.maximum(mean_free_path, 1e-4)
    sigma_s = jnp.clip(base_color, 0.0, 0.999) * sigma_t[..., None]
    sigma_s = jnp.maximum(sigma_s, 0.0) * jnp.maximum(1.0 - anisotropy, 0.01)[..., None]
    derived = jnp.maximum(sigma_t[..., None] - sigma_s, 1e-6)
    override = m.sss_sigma_override > 0.5
    return where3(override, jnp.maximum(m.sss_sigma_a, 1e-6), derived)


def sss_sigma_s_prime(m, base_color, mean_free_path, anisotropy):
    """(reference: pathtrace.metal sss_sigma_s_prime:3933-3949)"""
    sigma_t = 1.0 / jnp.maximum(mean_free_path, 1e-4)
    derived = jnp.clip(base_color, 0.0, 0.999) * sigma_t[..., None]
    derived = jnp.maximum(derived, 0.0)
    override_s = jnp.maximum(m.sss_sigma_s, 0.0)
    override = m.sss_sigma_override > 0.5
    out = where3(override, override_s, derived)
    return out * jnp.maximum(1.0 - anisotropy, 0.01)[..., None]


def normalized_diffusion_profile(radius, sigma_a, sigma_s_prime):
    """Two-exponential dipole-style profile
    (reference: pathtrace.metal normalized_diffusion_profile:3951-3973)."""
    sigma_t_prime = jnp.maximum(sigma_a + sigma_s_prime, 1e-6)
    alpha_prime = jnp.clip(sigma_s_prime / sigma_t_prime, 0.0, 1.0)
    d = 1.0 / jnp.maximum(3.0 * sigma_t_prime, 1e-6)
    sigma_tr = jnp.sqrt(jnp.maximum(sigma_a / d, 1e-6))
    r = jnp.maximum(radius, 1e-4)[..., None]
    zr = 1.0 / sigma_t_prime
    dr = jnp.sqrt(r * r + zr * zr)
    vr = zr + 4.0 * d
    dv = jnp.sqrt(r * r + vr * vr)
    term_dr = (zr * (1.0 + sigma_tr * dr)) / jnp.maximum(dr ** 3, 1e-6)
    term_dv = (vr * (1.0 + sigma_tr * dv)) / jnp.maximum(dv ** 3, 1e-6)
    profile = (alpha_prime / (4.0 * PI)) * (
        term_dr * jnp.exp(-sigma_tr * dr) + term_dv * jnp.exp(-sigma_tr * dv))
    return jnp.maximum(profile, 0.0)


def sss_sigma_tr_scalar(sigma_a, sigma_s_prime):
    """(reference: pathtrace.metal sss_sigma_tr_scalar:3975-3982)"""
    sigma_t_prime = jnp.maximum(sigma_a + sigma_s_prime, 1e-6)
    d = 1.0 / jnp.maximum(3.0 * sigma_t_prime, 1e-6)
    sigma_tr = jnp.sqrt(jnp.maximum(sigma_a / d, 1e-6))
    return jnp.maximum(luminance(sigma_tr), 1e-4)


def sample_henyey_greenstein_local(g, state):
    """(reference: pathtrace.metal sample_henyey_greenstein_local)"""
    state, u1 = rng_ops.rand_uniform(state)
    state, u2 = rng_ops.rand_uniform(state)
    iso = jnp.abs(g) < 1e-3
    s = (1.0 - g * g) / (1.0 - g + 2.0 * g * u1)
    cos_aniso = jnp.clip((1.0 + g * g - s * s) / (2.0 * jnp.where(iso, 1.0, g)),
                         -1.0, 1.0)
    cos_theta = jnp.where(iso, 1.0 - 2.0 * u1, cos_aniso)
    sin_theta = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_theta * cos_theta))
    phi = 2.0 * PI * u2
    local = jnp.stack([sin_theta * jnp.cos(phi), sin_theta * jnp.sin(phi),
                       cos_theta], -1)
    return state, local


def sample_henyey_greenstein_world(reference_dir, g, state):
    state, local = sample_henyey_greenstein_local(g, state)
    ref = safe_normalize(reference_dir)
    tangent, bitangent = build_onb(ref)
    world = (local[..., 0:1] * tangent + local[..., 1:2] * bitangent
             + local[..., 2:3] * ref)
    return state, safe_normalize(world)


def offset_surface_point(point, normal, direction):
    """(reference: pathtrace.metal offset_surface_point)"""
    ok = jnp.all(jnp.isfinite(normal), -1) & (dot(normal, normal) > 0.0)
    n = where3(ok, safe_normalize(normal),
               jnp.asarray([0.0, 1.0, 0.0], jnp.float32))
    sign = jnp.where(dot(direction, n) >= 0.0, 1.0, -1.0)
    origin = point + n * (sign * C.RAY_ORIGIN_EPSILON * 4.0)[..., None]
    return origin + direction * (C.RAY_ORIGIN_EPSILON * 0.5)


def sample_subsurface(m, position, normal, wo, state, clamp_p: ClampParams,
                      sss_mode: int, specular_only: bool):
    """sample_bsdf case 5: separable BSSRDF or lambert fallback
    (reference: pathtrace.metal:5420-5508). The random walk variant is
    driven by the integrator (see sample_sss_random_walk)."""
    shape = normal.shape[:-1]
    if specular_only:
        return state, BsdfSample.invalid(shape)

    mean_free_path = jnp.maximum(m.sss_mfp, 1e-4)
    use_separable_static = (sss_mode == 1)

    if not use_separable_static:
        # Lambert fallback only (2 draws)
        return _lambert_fallback(m, normal, state)

    anisotropy = jnp.clip(m.sss_g, -0.99, 0.99)
    base_color = material_base_color(m)
    sigma_a = sss_sigma_a(m, base_color, mean_free_path, anisotropy)
    sigma_sp = sss_sigma_s_prime(m, base_color, mean_free_path, anisotropy)
    sigma_tr = sss_sigma_tr_scalar(sigma_a, sigma_sp)

    # separable lanes: material method == separable and mfp usable
    lane_separable = (m.sss_method < 0.5) & (mean_free_path > 1e-4) \
        & (sigma_tr > 0.0)

    # --- separable branch: 4 draws (radius, phi, 2x cosine)
    st = state
    st, u_r = rng_ops.rand_uniform(st)
    u_r = jnp.clip(u_r, 1e-6, 1.0 - 1e-6)
    radius = -jnp.log(1.0 - u_r) / jnp.maximum(sigma_tr, 1e-4)
    radius = jnp.minimum(radius, mean_free_path * 10.0)
    pdf_radius = jnp.maximum(sigma_tr, 1e-4) * jnp.exp(
        -jnp.maximum(sigma_tr, 1e-4) * radius)
    st, u_phi = rng_ops.rand_uniform(st)
    phi = 2.0 * PI * u_phi
    tangent, bitangent = build_onb(normal)
    disp_x = radius * jnp.cos(phi)
    disp_y = radius * jnp.sin(phi)
    exit_point = position + tangent * disp_x[..., None] + bitangent * disp_y[..., None]
    exit_normal = normal

    st, local = rng_ops.sample_cosine_hemisphere(st)
    wi = safe_normalize(to_world(local, exit_normal))
    cos_exit = dot(exit_normal, wi)
    pdf_dir = lambert_pdf(exit_normal, wi)
    pdf_area = pdf_radius / (2.0 * PI * jnp.maximum(radius, 1e-4))

    profile = normalized_diffusion_profile(radius, sigma_a, sigma_sp)
    coat_tint = jnp.clip(m.coat_tint, 0.0, 1.0)
    coat_average = 1.0 - jnp.clip(m.coat_fresnel_avg, 0.0, 1.0)
    coat_ior = jnp.maximum(m.coat_ior, 1.0)
    f0 = ((coat_ior - 1.0) / (coat_ior + 1.0)) ** 2
    cos_in = jnp.maximum(dot(normal, wo), 0.0)
    trans_in = 1.0 - schlick_fresnel_scalar(f0, cos_in)
    trans_out = 1.0 - schlick_fresnel_scalar(f0, cos_exit)
    coat_transmission = jnp.clip(trans_in * trans_out, 0.0, 1.0)
    has_coat = m.sss_coat > 0.5
    profile = where3(has_coat, profile * coat_tint, profile)
    coat_trans_eff = jnp.where(has_coat, coat_transmission, 1.0)

    weight = profile * (cos_exit * coat_average * coat_trans_eff)[..., None]
    denom = jnp.maximum(pdf_area * pdf_dir, 1e-6)
    weight = jnp.maximum(weight / denom[..., None], 0.0)
    sep_ok = (lane_separable & (pdf_radius > 0.0) & jnp.isfinite(pdf_radius)
              & (cos_exit > 0.0) & (pdf_dir > 0.0) & (pdf_area > 0.0)
              & jnp.all(jnp.isfinite(weight), -1))

    sep = BsdfSample.invalid(shape)
    sep = sep.replace(
        direction=where3(sep_ok, wi, sep.direction),
        weight=where3(sep_ok, weight, sep.weight),
        pdf=jnp.where(sep_ok, denom, 0.0),
        directional_pdf=jnp.where(sep_ok, pdf_dir, 0.0),
        is_bssrdf=sep_ok,
        has_exit_point=sep_ok,
        exit_point=where3(sep_ok, exit_point, sep.exit_point),
        exit_normal=where3(sep_ok, exit_normal, sep.exit_normal))

    # --- lambert fallback branch: 2 draws
    fb_state, fb = _lambert_fallback(m, normal, state)

    from metal_pathtracer.ops.bsdf import _select_sample
    out = _select_sample(lane_separable, sep, fb)
    new_state = jnp.where(lane_separable, st, fb_state)
    return new_state, out


def _lambert_fallback(m, normal, state):
    """(reference: pathtrace.metal:5482-5508)"""
    shape = normal.shape[:-1]
    state, local = rng_ops.sample_cosine_hemisphere(state)
    wi = safe_normalize(to_world(local, normal))
    cos_i = dot(normal, wi)
    pdf = lambert_pdf(normal, wi)
    albedo = material_base_color(m)
    weight = jnp.maximum((albedo / PI) * (cos_i / jnp.maximum(pdf, 1e-20))[..., None], 0.0)
    ok = (cos_i > 0.0) & (pdf > 0.0) & jnp.all(jnp.isfinite(weight), -1)
    out = BsdfSample.invalid(shape)
    out = out.replace(
        direction=where3(ok, wi, out.direction),
        weight=where3(ok, weight, out.weight),
        pdf=jnp.where(ok, pdf, 0.0),
        directional_pdf=jnp.where(ok, pdf, 0.0),
        lobe_roughness=jnp.where(ok, 1.0, 0.0))
    return state, out


def sample_sss_random_walk(scene, m, rec, wo, incident, state,
                           clamp_p: ClampParams, sss_max_steps: int):
    """Volumetric random walk through the object's interior
    (reference: sample_sss_random_walk_software:4060-4310).

    Runs `sss_max_steps` masked steps; each step traces the full wavefront
    against the scene (only walking lanes active). Returns (state, sample).
    """
    from metal_pathtracer.ops import intersect

    shape = rec.normal.shape[:-1]
    front = rec.front_face

    p_coat = jnp.clip(m.coat_sample_weight, 0.0, 1.0)
    state, rand_lobe = rng_ops.rand_uniform(state)
    state = jnp.where(front, state, state)  # draws only on front-face lanes
    take_coat = (p_coat > 0.0) & (rand_lobe < p_coat)

    # --- coat lobe (2 draws)
    coat_roughness = plastic_coat_roughness(m)
    alpha = coat_roughness * coat_roughness
    f0 = plastic_coat_f0(m)
    f0c = jnp.broadcast_to(f0[..., None], rec.normal.shape)
    spec_tint = plastic_specular_tint(m)
    state_c, wh = sample_ggx_vndf(rec.normal, wo, coat_roughness, state)
    wi_c = safe_normalize(reflect(-wo, wh))
    cos_i = dot(rec.normal, wi_c)
    cos_o = dot(rec.normal, wo)
    d = ggx_d(alpha, rec.normal, wh)
    g = ggx_g1(alpha, cos_o) * ggx_g1(alpha, cos_i)
    fr = schlick_fresnel(f0c, dot(wi_c, wh))
    spec = fr * (d * g / jnp.maximum(4.0 * cos_o * cos_i, 1e-6))[..., None]
    spec = clamp_specular_tail(spec * spec_tint, coat_roughness, f0c, clamp_p)
    spec_pdf_raw = ggx_pdf(alpha, rec.normal, wo, wi_c)
    spec_pdf = clamp_specular_pdf(spec_pdf_raw, clamp_p)
    combined_pdf = jnp.maximum(p_coat * spec_pdf, 1e-6)
    weight_c = jnp.maximum(spec * (cos_i / combined_pdf)[..., None], 0.0)
    coat_ok = ((dot(wh, rec.normal) > 0.0) & jnp.all(jnp.isfinite(wi_c), -1)
               & (cos_i > 0.0) & (cos_o > 0.0) & (dot(wi_c, wh) > 0.0)
               & (spec_pdf_raw > 0.0) & jnp.all(jnp.isfinite(weight_c), -1))
    coat = BsdfSample.invalid(shape)
    coat = coat.replace(
        direction=where3(coat_ok, wi_c, coat.direction),
        weight=where3(coat_ok, weight_c, coat.weight),
        pdf=jnp.where(coat_ok, combined_pdf, 0.0),
        directional_pdf=jnp.where(coat_ok, spec_pdf, 0.0),
        lobe_type=jnp.where(coat_ok, 1, 0),
        lobe_roughness=jnp.where(coat_ok, coat_roughness, 0.0))

    # --- walk lobe
    p_diffuse = jnp.maximum(1.0 - p_coat, 1e-3)
    anisotropy = jnp.clip(m.sss_g, -0.99, 0.99)
    mean_free_path = jnp.maximum(m.sss_mfp, 1e-4)
    base_color = material_base_color(m)
    sigma_a = sss_sigma_a(m, base_color, mean_free_path, anisotropy)
    sigma_sp = sss_sigma_s_prime(m, base_color, mean_free_path, anisotropy)
    sigma_t = jnp.maximum(sigma_a + sigma_sp, 1e-6)
    sigma_t_scalar = jnp.maximum(jnp.max(sigma_t, -1), 1e-4)

    throughput = jnp.ones(shape + (3,), jnp.float32) / p_diffuse[..., None]

    eta_outside = jnp.ones(shape, jnp.float32)
    eta_inside = jnp.maximum(m.eta, 1.0)
    entry_normal = rec.normal
    unit_dir = incident
    cos_theta_i = dot(-unit_dir, entry_normal)
    fr_entry, cos_theta_t = fresnel_dielectric_exact(
        cos_theta_i, eta_outside, eta_inside)
    enter_dir = refract(unit_dir, entry_normal,
                        (eta_outside / eta_inside)[..., None])
    enter_ok = (cos_theta_i > 0.0) & jnp.all(jnp.isfinite(enter_dir), -1) \
        & (dot(enter_dir, enter_dir) > 0.0)
    enter_dir = safe_normalize(enter_dir)

    eta_scale = (eta_inside * eta_inside) / (eta_outside * eta_outside)
    dir_scale = eta_scale * (cos_theta_t / jnp.maximum(cos_theta_i, 1e-6))
    throughput = throughput * (jnp.maximum(1.0 - fr_entry, 0.0) * dir_scale)[..., None]
    has_coat = m.sss_coat > 0.5
    throughput = jnp.where(has_coat[..., None],
                           throughput * plastic_specular_tint(m), throughput)

    current_pos = offset_surface_point(rec.point, -entry_normal, enter_dir)
    current_dir = enter_dir

    walking = front & jnp.logical_not(take_coat) & enter_ok
    exited = jnp.zeros(shape, bool)
    exit_point = jnp.zeros(shape + (3,), jnp.float32)
    exit_normal = jnp.zeros(shape + (3,), jnp.float32)
    exit_dir = jnp.zeros(shape + (3,), jnp.float32)
    exit_throughput = jnp.zeros(shape + (3,), jnp.float32)

    def step(_, carry):
        (st, walking, pos, dirn, tp, exited, e_pt, e_n, e_dir, e_tp) = carry
        st0 = st
        st, xi = rng_ops.rand_uniform(st)
        xi = jnp.clip(xi, 1e-6, 1.0 - 1e-6)
        distance = -jnp.log(1.0 - xi) / sigma_t_scalar

        b_rec = intersect.trace_scene(pos, dirn, scene,
                                      C.RAY_ORIGIN_EPSILON, C.INFINITY_T)
        no_boundary = jnp.logical_not(b_rec.hit)
        boundary_dist = jnp.maximum(b_rec.t, 1e-4)

        scatter = walking & b_rec.hit & (distance < boundary_dist)
        reach = walking & b_rec.hit & jnp.logical_not(distance < boundary_dist)

        # --- volume scatter event: HG redirection (2 more draws)
        tp_scatter = tp * jnp.exp(-sigma_t * distance[..., None])
        scatter_albedo = jnp.clip(sigma_sp / jnp.maximum(sigma_t, 1e-6), 0.0, 1.0)
        tp_scatter = tp_scatter * scatter_albedo
        tp_max_s = jnp.max(tp_scatter, -1)
        cutoff_s = tp_max_s < SSS_THROUGHPUT_CUTOFF
        st_hg, new_dir = sample_henyey_greenstein_world(-dirn, anisotropy, st)
        dir_ok = jnp.all(jnp.isfinite(new_dir), -1) & (dot(new_dir, new_dir) > 0.0)
        pos_scatter = pos + dirn * distance[..., None]

        # --- boundary event
        tp_reach = tp * jnp.exp(-sigma_t * boundary_dist[..., None])
        tp_max_r = jnp.max(tp_reach, -1)
        cutoff_r = tp_max_r < SSS_THROUGHPUT_CUTOFF
        outward = where3(b_rec.front_face, b_rec.normal, -b_rec.normal)
        outward_ok = jnp.all(jnp.isfinite(outward), -1) & (dot(outward, outward) > 0.0)
        outward = safe_normalize(outward)
        cos_exit_i = dot(-dirn, outward)
        internal = cos_exit_i <= 0.0
        fr_exit, cos_exit_t = fresnel_dielectric_exact(
            cos_exit_i, eta_inside, jnp.ones_like(eta_inside))
        refracted = refract(dirn, outward, eta_inside[..., None])
        refract_fail = jnp.logical_not(
            jnp.all(jnp.isfinite(refracted), -1) & (dot(refracted, refracted) > 0.0))
        refracted = safe_normalize(refracted)
        eta_scale_exit = 1.0 / (eta_inside * eta_inside)
        dir_scale_exit = eta_scale_exit * (cos_exit_t / jnp.maximum(cos_exit_i, 1e-6))
        tp_exit = tp_reach * (jnp.maximum(1.0 - fr_exit, 0.0) * dir_scale_exit)[..., None]
        tp_exit = jnp.where(has_coat[..., None],
                            tp_exit * plastic_specular_tint(m), tp_exit)
        tp_exit = jnp.maximum(tp_exit, 0.0)
        exit_bad = jnp.logical_not(jnp.all(jnp.isfinite(tp_exit), -1))

        tir = reach & jnp.logical_not(cutoff_r) & outward_ok \
            & (internal | refract_fail)
        exit_now = reach & jnp.logical_not(cutoff_r) & outward_ok \
            & jnp.logical_not(internal) & jnp.logical_not(refract_fail) \
            & jnp.logical_not(exit_bad)

        # commit exit lanes
        e_pt = where3(exit_now, b_rec.point, e_pt)
        e_n = where3(exit_now, outward, e_n)
        e_dir = where3(exit_now, refracted, e_dir)
        e_tp = where3(exit_now, tp_exit, e_tp)
        exited = exited | exit_now

        # continue: scatter lanes (not cutoff, dir ok) and TIR lanes
        cont_scatter = scatter & jnp.logical_not(cutoff_s) & dir_ok
        new_pos = where3(cont_scatter, pos_scatter, where3(tir, b_rec.point, pos))
        reflected = safe_normalize(reflect(dirn, outward))
        new_dirn = where3(cont_scatter, new_dir, where3(tir, reflected, dirn))
        new_tp = jnp.where(cont_scatter[..., None], tp_scatter,
                           jnp.where(tir[..., None], tp_reach, tp))
        still_walking = cont_scatter | tir

        # state: walking lanes consumed the distance draw; scatter lanes the
        # HG draws on top (cutoff lanes break before HG draws)
        st_out = jnp.where(walking, st, st0)
        st_out = jnp.where(scatter & jnp.logical_not(cutoff_s), st_hg, st_out)

        return (st_out, walking & still_walking, new_pos, new_dirn, new_tp,
                exited, e_pt, e_n, e_dir, e_tp)

    carry = (state, walking, current_pos, current_dir, throughput,
             exited, exit_point, exit_normal, exit_dir, exit_throughput)
    (state_w, _, _, _, _, exited, exit_point, exit_normal, exit_dir,
     exit_throughput) = jax.lax.fori_loop(0, max(int(sss_max_steps), 1),
                                          step, carry)

    walk = BsdfSample.invalid(shape)
    walk = walk.replace(
        direction=where3(exited, exit_dir, walk.direction),
        weight=where3(exited, exit_throughput, walk.weight),
        pdf=jnp.where(exited, jnp.maximum(p_diffuse, 1e-4), 0.0),
        directional_pdf=jnp.where(exited, 1.0, 0.0),
        is_bssrdf=exited,
        has_exit_point=exited,
        exit_point=where3(exited, exit_point, walk.exit_point),
        exit_normal=where3(exited, exit_normal, walk.exit_normal))

    from metal_pathtracer.ops.bsdf import _select_sample
    out = _select_sample(take_coat, coat, walk)
    new_state = jnp.where(take_coat, state_c, state_w)
    # lanes that never entered the walk (front==0 etc.) keep invalid sample
    inactive = jnp.logical_not(front)
    out = _select_sample(inactive, BsdfSample.invalid(shape), out)
    return new_state, out
