"""Specular-NEE and "MNEE" delta-chain direct-light estimators.

Vectorized port of the long tail of the reference integrator
(reference: shaders/pathtrace.metal:6770-7235 and shaders/mnee.metal).
Despite the name, the reference implements *specular-chain NEE with MIS*
— extra shadow/chain traces along delta bounce directions against the
environment and emissive rectangles — not a true manifold walk
(SURVEY.md §2.2 note); we replicate the implemented behavior.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from metal_pathtracer import constants as C
from metal_pathtracer.ops import bsdf as bsdf_ops
from metal_pathtracer.ops import intersect
from metal_pathtracer.ops.vecmath import dot, normalize, safe_normalize, where3

PDF_FLOOR = 1.0e-4       # kSpecularNeePdfFloor (pathtrace.metal:38)
INV_PDF_CLAMP = 1.0e4    # kSpecularNeeInvPdfClamp (pathtrace.metal:39)


def _mis(light_pdf, bsdf_pdf):
    light_pdf = jnp.maximum(light_pdf, PDF_FLOOR)
    inv = jnp.minimum(1.0 / light_pdf, INV_PDF_CLAMP)
    bsdf_pdf = jnp.maximum(bsdf_pdf, PDF_FLOOR)
    denom = light_pdf + bsdf_pdf
    w = jnp.where(denom > 0.0, light_pdf / denom, 0.0)
    w = jnp.clip(w, C.MIS_WEIGHT_CLAMP_MIN, C.MIS_WEIGHT_CLAMP_MAX)
    return w * inv


def _rect_hit_light(scene, uniforms, static, rec, origin):
    """mnee_rect_light_hit (reference: shaders/mnee.metal:1-62).
    Returns (emission (N,3), pdf (N,), valid (N,))."""
    from metal_pathtracer.ops.integrator import _rect_light_pdf_for_hit

    mats = scene.materials
    rects = scene.rects
    idx = jnp.clip(rec.prim_index, 0, max(rects.count - 1, 0))
    mat_idx = jnp.clip(rects.material[idx], 0, mats.count - 1)
    is_light = (mats.mat_type[mat_idx] == C.MATERIAL_DIFFUSE_LIGHT) \
        & jnp.any(mats.emission[mat_idx] != 0.0, -1)
    emission = mats.emission[mat_idx]
    if static.background_mode == 2 and scene.environment is not None:
        from metal_pathtracer.ops import env as env_ops
        env_mod = env_ops.environment_color(
            scene.environment, -rec.shading_normal,
            uniforms.environment_rotation, uniforms.environment_intensity,
            static)
        use_env = (mats.emission_env[mat_idx] > 0.0) & rec.front_face
        emission = jnp.where(use_env[..., None], emission * env_mod, emission)
    pdf = _rect_light_pdf_for_hit(scene, rec, origin)
    valid = ((rec.prim_type == C.PRIMITIVE_RECTANGLE) & is_light
             & (rec.front_face | rec.two_sided)
             & jnp.any(emission != 0.0, -1)
             & (pdf > 0.0) & jnp.isfinite(pdf))
    return emission, pdf, valid


def delta_chain_estimators(scene, uniforms, static, clamp_p, throughput,
                           smp, next_origin, rec, shading_normal,
                           next_specular_depth, state, active, is_dielectric):
    """All spec-NEE / MNEE contributions for this bounce.

    Returns (radiance_delta (N,3), n_scene_traces (), n_shadow_traces ())
    — the counts feed the Mrays/s perf counters (chain traces are real
    scene traces; leaving them out understates throughput whenever
    spec-NEE is on, the reference default). `state` is consumed
    read-only — the reference forks a copy for the secondary chain
    (pathtrace.metal:7113).
    """
    shape = active.shape
    radiance = jnp.zeros(shape + (3,), jnp.float32)
    n_scene = jnp.float32(0.0)
    n_shadow = jnp.float32(0.0)

    env_sampling = (static.background_mode == 2 and scene.environment is not None)
    n_rect_lights = (scene.light_rect_indices.shape[0]
                     if scene.light_rect_indices is not None else 0)
    if not (static.enable_specular_nee or static.enable_mnee):
        return radiance, n_scene, n_shadow
    if not env_sampling and n_rect_lights == 0:
        return radiance, n_scene, n_shadow

    dir_len_sq = dot(smp.direction, smp.direction)
    dir_valid = (dir_len_sq > 0.0) & jnp.all(jnp.isfinite(smp.direction), -1)

    # didTransmission for dielectrics (reference: pathtrace.metal:6727-6738)
    side = jnp.where(rec.front_face, 1.0, -1.0)
    did_transmission = is_dielectric & smp.is_delta & \
        ((dot(shading_normal, smp.direction) * side) < 0.0)

    # mneeEligible (reference: pathtrace.metal:6777-6782)
    mnee_eligible = jnp.zeros(shape, bool)
    if static.enable_mnee:
        mnee_eligible = (smp.is_delta
                         & ((smp.medium_event <= 0) | did_transmission)
                         & is_dielectric
                         & (next_specular_depth == 1)
                         & dir_valid)
    spec_eligible = jnp.zeros(shape, bool)
    if static.enable_specular_nee:
        spec_eligible = (smp.is_delta & (smp.medium_event <= 0)
                         & dir_valid & jnp.logical_not(mnee_eligible))

    nee_dir = safe_normalize(smp.direction)

    def env_estimator(lanes, origin, direction, weight, bsdf_pdf):
        from metal_pathtracer.ops import env as env_ops
        lane_tmax = jnp.where(lanes, C.INFINITY_T, 0.0)
        occluded = intersect.trace_occluded(origin, direction, scene,
                                            C.EPSILON_T, lane_tmax)
        env_pdf = env_ops.environment_pdf(scene.environment, direction,
                                          uniforms.environment_rotation)
        factor = _mis(env_pdf, bsdf_pdf)
        env_color = env_ops.environment_color(
            scene.environment, direction, uniforms.environment_rotation,
            uniforms.environment_intensity, static)
        contribution = weight * env_color * factor[..., None]
        ok = lanes & jnp.logical_not(occluded) \
            & jnp.all(jnp.isfinite(contribution), -1)
        clamped = bsdf_ops.clamp_firefly_contribution(throughput, contribution,
                                                      clamp_p)
        return jnp.where(ok[..., None], clamped, 0.0)

    def rect_estimator(lanes, origin, direction, weight, bsdf_pdf):
        lane_tmax = jnp.where(lanes, C.INFINITY_T, 0.0)
        hit = intersect.trace_scene(origin, direction, scene,
                                    C.EPSILON_T, lane_tmax)
        emission, pdf, valid = _rect_hit_light(scene, uniforms, static, hit,
                                               origin)
        factor = _mis(pdf, bsdf_pdf)
        contribution = weight * emission * factor[..., None]
        ok = lanes & hit.hit & valid & jnp.all(jnp.isfinite(contribution), -1)
        clamped = bsdf_ops.clamp_firefly_contribution(throughput, contribution,
                                                      clamp_p)
        return jnp.where(ok[..., None], clamped, 0.0)

    primary_lanes = active & (spec_eligible | mnee_eligible)
    bsdf_pdf = smp.directional_pdf
    if env_sampling:
        radiance = radiance + env_estimator(primary_lanes, next_origin,
                                            nee_dir, smp.weight, bsdf_pdf)
        n_shadow = n_shadow + jnp.sum(primary_lanes.astype(jnp.float32))
    if n_rect_lights > 0:
        radiance = radiance + rect_estimator(primary_lanes, next_origin,
                                             nee_dir, smp.weight, bsdf_pdf)
        n_scene = n_scene + jnp.sum(primary_lanes.astype(jnp.float32))

    # ---- secondary chain (reference: pathtrace.metal:7060-7232) --------
    if static.enable_mnee and static.enable_mnee_secondary:
        chain_lanes = active & mnee_eligible
        chain_tmax = jnp.where(chain_lanes, C.INFINITY_T, 0.0)
        chain_rec = intersect.trace_scene(next_origin, nee_dir, scene,
                                          C.EPSILON_T, chain_tmax)
        n_scene = n_scene + jnp.sum(chain_lanes.astype(jnp.float32))
        # skip chain hits that are themselves lights
        if n_rect_lights > 0:
            _, _, hit_is_light = _rect_hit_light(scene, uniforms, static,
                                                 chain_rec, next_origin)
        else:
            hit_is_light = jnp.zeros(shape, bool)
        m2 = bsdf_ops.gather_material(
            scene.materials, jnp.clip(chain_rec.material, 0,
                                      scene.materials.count - 1))
        chain_delta = bsdf_ops.material_is_delta(m2)
        chain_ok = chain_lanes & chain_rec.hit & jnp.logical_not(hit_is_light) \
            & chain_delta

        chain_normal = chain_rec.normal
        bad = jnp.logical_not(jnp.all(jnp.isfinite(chain_normal), -1)) | \
            (dot(chain_normal, chain_normal) <= 0.0)
        chain_normal = where3(bad, jnp.asarray([0.0, 1.0, 0.0], jnp.float32),
                              chain_normal)
        chain_normal = normalize(chain_normal)
        chain_incident = normalize(nee_dir)
        chain_wo = -chain_incident
        # The reference samples with a *copy* of the RNG state
        # (pathtrace.metal:7113) — the main stream is unaffected.
        _, chain_smp = bsdf_ops.sample_bsdf(
            m2, chain_rec.point, chain_normal, chain_wo, chain_incident,
            chain_rec.front_face, state, clamp_p, static.sss_mode,
            jnp.ones(shape, jnp.float32), static.debug_specular_only,
            static.material_types)
        chain_ok = chain_ok & (chain_smp.pdf > 0.0) & chain_smp.is_delta \
            & (chain_smp.medium_event <= 0)
        chain_dir = safe_normalize(chain_smp.direction)
        chain_ok = chain_ok & jnp.all(jnp.isfinite(chain_dir), -1) \
            & (dot(chain_dir, chain_dir) > 0.0)
        chain_rec2 = chain_rec.replace(shading_normal=chain_rec.shading_normal)
        chain_origin = intersect.offset_ray_origin(chain_rec2, chain_dir)
        combined_weight = smp.weight * chain_smp.weight
        combined_pdf = jnp.maximum(
            smp.directional_pdf * chain_smp.directional_pdf, PDF_FLOOR)
        if env_sampling:
            radiance = radiance + env_estimator(chain_ok, chain_origin,
                                                chain_dir, combined_weight,
                                                combined_pdf)
            n_shadow = n_shadow + jnp.sum(chain_ok.astype(jnp.float32))
        if n_rect_lights > 0:
            radiance = radiance + rect_estimator(chain_ok, chain_origin,
                                                 chain_dir, combined_weight,
                                                 combined_pdf)
            n_scene = n_scene + jnp.sum(chain_ok.astype(jnp.float32))

    return radiance, n_scene, n_shadow
