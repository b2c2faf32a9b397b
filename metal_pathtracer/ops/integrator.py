"""Wavefront path integrator.

A wavefront re-design of the reference's GPU megakernel
(reference: shaders/pathtrace.metal trace_path_software:5717-7284 and the
kernel entry pathtraceIntegrateKernel:9698-9815).

Architecture notes (SURVEY.md §7):
- One SoA wavefront of rays over flat pixel lanes instead of one thread per
  pixel; every stage is a masked vector op that XLA fuses, and BVH
  traversal is one kernel per trace (ops/pallas/traverse.py).
- The bounce loop is a `lax.fori_loop` with a static `max_depth` bound and a
  per-lane `alive` mask — no data-dependent control flow in the jit trace.
- RNG is the reference's per-lane uint32 PCG stream; every draw is masked so
  a lane's stream advances exactly as the reference's per-thread stream.
- Static specialization (schema.StaticConfig) replaces the reference's
  runtime MSL compilation with preprocessor flags.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from metal_pathtracer import constants as C
from metal_pathtracer.ops import bsdf as bsdf_ops
from metal_pathtracer.ops import camera as camera_ops
from metal_pathtracer.ops import intersect
from metal_pathtracer.ops import rng as rng_ops
from metal_pathtracer.ops.vecmath import (
    dot,
    linear_srgb_to_acescg,
    normalize,
    safe_normalize,
    where3,
)
from metal_pathtracer.schema import SceneArrays, StaticConfig, Uniforms


def sky_color(direction):
    """Gradient background (reference: pathtrace.metal sky_color:1320-1325)."""
    unit = normalize(direction)
    t = 0.5 * (unit[..., 1:2] + 1.0)
    white = jnp.asarray([1.0, 1.0, 1.0], jnp.float32)
    blue = jnp.asarray([0.5, 0.7, 1.0], jnp.float32)
    return white + (blue - white) * t


def to_working_space(color, static: StaticConfig):
    """(reference: pathtrace.metal to_working_space:100-107)"""
    if static.working_color_space == 1:
        return linear_srgb_to_acescg(color)
    return color


class PathCarry(NamedTuple):
    state: jax.Array        # (N,)  uint32 RNG
    ray_o: jax.Array        # (N,3)
    ray_d: jax.Array        # (N,3)
    throughput: jax.Array   # (N,3)
    radiance: jax.Array     # (N,3)
    alive: jax.Array        # (N,)  bool
    last_pdf: jax.Array     # (N,)
    last_delta: jax.Array   # (N,)  bool
    prev_valid: jax.Array   # (N,)  bool
    prev_mesh: jax.Array    # (N,)  i32 — triangle self-hit exclusion
    prev_prim: jax.Array    # (N,)  i32
    medium_stack: jax.Array  # (N,MAX_MEDIUM_STACK,3)
    medium_depth: jax.Array  # (N,) i32
    is_first_hit: jax.Array  # (N,) bool
    aov_albedo: jax.Array   # (N,3)
    aov_normal: jax.Array   # (N,3)
    specular_depth: jax.Array  # (N,) i32
    env_lod: jax.Array      # (N,)
    env_lod_active: jax.Array  # (N,) bool
    n_rays: jax.Array       # ()  f32 — scene traces issued (perf counter)
    n_shadow_rays: jax.Array  # () f32 — shadow traces issued
    cone_width: jax.Array   # (N,) f32 — ray cone (reference: RayCone)
    cone_spread: jax.Array  # (N,) f32


def _primary_cone_spread(uniforms: Uniforms, static: StaticConfig):
    """(reference: pathtrace.metal make_primary_ray_cone)"""
    from metal_pathtracer.ops.vecmath import length as vlen

    pixel_x = vlen(uniforms.camera.horizontal) / max(float(static.width), 1.0)
    pixel_y = vlen(uniforms.camera.vertical) / max(float(static.height), 1.0)
    footprint = jnp.maximum(jnp.maximum(pixel_x, pixel_y), 1e-6)
    center = (uniforms.camera.lower_left + 0.5 * uniforms.camera.horizontal
              + 0.5 * uniforms.camera.vertical)
    focus = vlen(center - uniforms.camera.origin)
    return footprint / jnp.maximum(focus, 1e-6)


def _rect_light_pdf_for_hit(scene: SceneArrays, rec, origin):
    """Solid-angle pdf of sampling the hit rectangle via NEE, for MIS on
    emissive hits (reference: pathtrace.metal rect_light_pdf_for_hit)."""
    n_lights = scene.light_rect_indices.shape[0]
    rects = scene.rects
    idx = jnp.clip(rec.prim_index, 0, rects.count - 1)
    mat_idx = jnp.clip(rects.material[idx], 0, scene.materials.count - 1)
    is_light = (scene.materials.mat_type[mat_idx] == C.MATERIAL_DIFFUSE_LIGHT) & \
        jnp.any(scene.materials.emission[mat_idx] != 0.0, -1)

    edge_u = rects.edge_u[idx]
    edge_v = rects.edge_v[idx]
    area = jnp.sqrt(jnp.maximum(dot(jnp.cross(edge_u, edge_v),
                                    jnp.cross(edge_u, edge_v)), 0.0))
    to_light = rec.point - origin
    dist_sq = dot(to_light, to_light)
    distance = jnp.sqrt(jnp.maximum(dist_sq, 1e-30))
    direction = to_light / distance[..., None]
    normal = rects.normal[idx]
    cos_light = dot(-direction, normal)
    two_sided = rects.two_sided[idx] > 0.5
    cos_light = jnp.where(two_sided, jnp.abs(cos_light), cos_light)

    pdf = (1.0 / jnp.maximum(area, 1e-20)) * dist_sq / jnp.maximum(cos_light, 1e-6)
    pdf = pdf / float(n_lights)
    valid = ((rec.prim_type == C.PRIMITIVE_RECTANGLE) & is_light
             & (area > 0.0) & (dist_sq > 0.0) & (cos_light > 0.0))
    return jnp.where(valid, pdf, 0.0)


def _rect_light_sample_from_uniforms(scene: SceneArrays, point, sel_u, u, v,
                                     static: StaticConfig,
                                     uniforms: Uniforms):
    """Rect-light NEE sample math from three pre-drawn uniforms (drawn
    by _sample_rect_light via rng_ops). Returns
    (direction, distance, pdf, emission, valid)."""
    n_lights = scene.light_rect_indices.shape[0]
    rects = scene.rects
    mats = scene.materials

    selected = jnp.minimum((sel_u * float(n_lights)).astype(jnp.uint32),
                           jnp.uint32(n_lights - 1)).astype(jnp.int32)
    rect_idx = scene.light_rect_indices[selected]

    edge_u = rects.edge_u[rect_idx]
    edge_v = rects.edge_v[rect_idx]
    sample_point = rects.corner[rect_idx] + u[..., None] * edge_u + v[..., None] * edge_v
    to_light = sample_point - point
    dist_sq = dot(to_light, to_light)
    distance = jnp.sqrt(jnp.maximum(dist_sq, 1e-30))
    direction = to_light / distance[..., None]

    cr = jnp.cross(edge_u, edge_v)
    area = jnp.sqrt(jnp.maximum(dot(cr, cr), 0.0))
    normal = rects.normal[rect_idx]
    cos_light = dot(-direction, normal)
    two_sided = rects.two_sided[rect_idx] > 0.5
    cos_ok = jnp.where(two_sided, True, cos_light > 0.0)
    cos_light = jnp.where(two_sided, jnp.abs(cos_light), cos_light)

    pdf = (1.0 / jnp.maximum(area, 1e-20)) * dist_sq / jnp.maximum(cos_light, 1e-6)
    pdf = pdf / float(n_lights)

    mat_idx = jnp.clip(rects.material[rect_idx], 0, mats.count - 1)
    emission = mats.emission[mat_idx]
    if static.background_mode == 2 and scene.environment is not None:
        from metal_pathtracer.ops import env as env_ops
        env_mod = env_ops.environment_color(
            scene.environment, -normal, uniforms.environment_rotation,
            uniforms.environment_intensity, static)
        emission = jnp.where((mats.emission_env[mat_idx] > 0.0)[..., None],
                             emission * env_mod, emission)

    valid = ((dist_sq > 0.0) & (area > 0.0) & cos_ok & (cos_light > 0.0)
             & (pdf > 0.0) & jnp.isfinite(pdf)
             & jnp.any(emission != 0.0, -1))
    return direction, distance, jnp.where(valid, pdf, 0.0), emission, valid


def _sample_rect_light(scene: SceneArrays, rec, state, static: StaticConfig,
                       uniforms: Uniforms):
    """NEE light sample over the scene's emissive rectangles
    (reference: pathtrace.metal sample_rect_light). Draws 3 uniforms.

    Returns (state, direction, distance, pdf, emission, valid).
    """
    state, sel_u = rng_ops.rand_uniform(state)
    state, u = rng_ops.rand_uniform(state)
    state, v = rng_ops.rand_uniform(state)
    direction, distance, pdf, emission, valid = \
        _rect_light_sample_from_uniforms(scene, rec.point, sel_u, u, v,
                                         static, uniforms)
    return state, direction, distance, pdf, emission, valid


#: per-bounce probe record fields (the counterpart of the reference's
#: 512-entry PathtraceDebugBuffer ring, MetalShaderTypes.h:270-287)
PROBE_FIELDS = ("hit", "t", "prim_type", "prim_index", "mesh_index",
                "material", "throughput_r", "throughput_g", "throughput_b",
                "radiance_r", "radiance_g", "radiance_b", "medium_depth",
                "medium_event", "pdf", "is_delta")


def trace_paths(scene: SceneArrays, uniforms: Uniforms, static: StaticConfig,
                state, ray_o, ray_d, record_probe: bool = False):
    """Trace a wavefront of primary rays to completion.

    Returns (state, radiance, aov_albedo, aov_normal[, probe_records]).
    With record_probe=True a (max_depth, N, 16) per-bounce record array is
    appended to the return — the debug ring buffer equivalent.
    """
    shape = ray_o.shape[:-1]
    clamp_p = bsdf_ops.make_clamp_params(uniforms)
    n_rect_lights = (scene.light_rect_indices.shape[0]
                     if scene.light_rect_indices is not None else 0)
    env_sampling = (static.background_mode == 2 and scene.environment is not None)
    types = set(static.material_types)
    # Medium events (refraction into/out of absorbing volumes) only occur
    # for these types; without them the 8-deep sigma stack is statically
    # empty — compiling it out removes ~25% of the loop's carried
    # device-memory traffic (17.9 GB per 262K-lane call by XLA's cost
    # analysis).
    has_medium = bool(types & {C.MATERIAL_DIELECTRIC, C.MATERIAL_PBR,
                               C.MATERIAL_SUBSURFACE})

    z3 = jnp.zeros(shape + (3,), jnp.float32)
    carry = PathCarry(
        state=state,
        ray_o=ray_o,
        ray_d=ray_d,
        throughput=jnp.ones(shape + (3,), jnp.float32),
        radiance=z3,
        alive=jnp.ones(shape, bool),
        last_pdf=jnp.ones(shape, jnp.float32),
        last_delta=jnp.ones(shape, bool),
        prev_valid=jnp.zeros(shape, bool),
        prev_mesh=jnp.full(shape, -1, jnp.int32),
        prev_prim=jnp.full(shape, -1, jnp.int32),
        medium_stack=jnp.zeros(
            shape + (C.MAX_MEDIUM_STACK if has_medium else 1, 3),
            jnp.float32),
        medium_depth=jnp.zeros(shape, jnp.int32),
        is_first_hit=jnp.ones(shape, bool),
        aov_albedo=z3,
        aov_normal=z3,
        specular_depth=jnp.zeros(shape, jnp.int32),
        env_lod=jnp.zeros(shape, jnp.float32),
        env_lod_active=jnp.zeros(shape, bool),
        n_rays=jnp.float32(0.0),
        n_shadow_rays=jnp.float32(0.0),
        # primary ray cone (reference: make_primary_ray_cone)
        cone_width=jnp.broadcast_to(
            jnp.maximum(2.0 * uniforms.camera.lens_radius, 0.0), shape),
        cone_spread=jnp.broadcast_to(_primary_cone_spread(uniforms, static),
                                     shape),
    )

    def body(depth, carry: PathCarry, records=None):
        cr = carry
        alive0 = cr.alive
        state0 = cr.state
        n_rays = cr.n_rays + jnp.sum(alive0.astype(jnp.float32))
        n_shadow_rays = cr.n_shadow_rays

        # ---- trace (with triangle self-hit exclusion) ------------------
        # Dead lanes trace with tmax=0: every AABB/primitive test fails
        # immediately, so they cost nothing inside the packet kernel.
        ex_mesh = jnp.where(cr.prev_valid, cr.prev_mesh, -1)
        ex_prim = jnp.where(cr.prev_valid, cr.prev_prim, -1)
        lane_tmax = jnp.where(alive0, C.INFINITY_T, 0.0)
        rec = intersect.trace_scene(cr.ray_o, cr.ray_d, scene,
                                    C.EPSILON_T, lane_tmax,
                                    exclude_mesh=ex_mesh, exclude_prim=ex_prim)

        radiance = cr.radiance

        # ---- miss: background (reference: pathtrace.metal:5800-5861) ---
        miss = jnp.logical_and(alive0, jnp.logical_not(rec.hit))
        use_specular_mis = jnp.logical_or(
            jnp.logical_not(cr.last_delta),
            static.enable_specular_nee or static.enable_mnee)

        def _miss_radiance(radiance_in):
            if static.background_mode == 1:
                background = jnp.broadcast_to(uniforms.background_color,
                                              shape + (3,))
                background = to_working_space(background, static)
            elif static.background_mode == 2 and scene.environment is not None:
                from metal_pathtracer.ops import env as env_ops
                background = env_ops.environment_background(
                    scene.environment, cr.ray_d, uniforms, static,
                    cr.env_lod, cr.env_lod_active)
            else:
                background = to_working_space(sky_color(cr.ray_d), static)

            mis_weight = jnp.ones(shape, jnp.float32)
            if env_sampling:
                from metal_pathtracer.ops import env as env_ops
                light_pdf = env_ops.environment_pdf(
                    scene.environment, cr.ray_d, uniforms.environment_rotation)
                denom = cr.last_pdf + light_pdf
                w = jnp.clip(cr.last_pdf / jnp.maximum(denom, 1e-30),
                             C.MIS_WEIGHT_CLAMP_MIN, C.MIS_WEIGHT_CLAMP_MAX)
                mis_weight = jnp.where(
                    jnp.logical_and(use_specular_mis, denom > 0.0),
                    w, mis_weight)
            bg_contrib = bsdf_ops.clamp_firefly_contribution(
                cr.throughput, background * mis_weight[..., None], clamp_p)
            return radiance_in + jnp.where(miss[..., None], bg_contrib, 0.0)

        if env_sampling:
            # Per-chunk skip: the env background+pdf lookups are ~13
            # gathers/lane; chunks with no miss lane this depth (fully
            # over geometry) add exactly zero, so skip them wholesale.
            radiance = jax.lax.cond(jnp.any(miss), _miss_radiance,
                                    lambda r: r, radiance)
        else:
            radiance = _miss_radiance(radiance)

        active = jnp.logical_and(alive0, rec.hit)

        # ---- medium absorption (Beer–Lambert, 8-deep stack)
        #      (reference: pathtrace.metal:5869-5876) --------------------
        if has_medium:
            in_medium = jnp.logical_and(active, cr.medium_depth > 0)
            top = jnp.clip(cr.medium_depth - 1, 0, C.MAX_MEDIUM_STACK - 1)
            top_onehot = (jnp.arange(C.MAX_MEDIUM_STACK) == top[..., None])
            sigma = jnp.sum(cr.medium_stack * top_onehot[..., None], axis=-2)
            segment = jnp.maximum(rec.t, 0.0)
            attenuation = jnp.exp(-sigma * segment[..., None])
            has_sigma = jnp.any(sigma > 0.0, -1)
            apply_att = jnp.logical_and(in_medium, has_sigma)
            throughput = jnp.where(apply_att[..., None],
                                   cr.throughput * attenuation, cr.throughput)
        else:
            throughput = cr.throughput

        # ---- material fetch & shading normal ---------------------------
        mat_idx = jnp.clip(rec.material, 0, scene.materials.count - 1)
        m = bsdf_ops.gather_material(scene.materials, mat_idx)
        incident = normalize(cr.ray_d)
        wo = -incident

        shading_normal = rec.shading_normal
        bad_sn = jnp.logical_or(
            jnp.logical_not(jnp.all(jnp.isfinite(shading_normal), -1)),
            dot(shading_normal, shading_normal) <= 0.0)
        shading_normal = where3(bad_sn, rec.normal, shading_normal)

        state = state0

        # ---- PBR texture pipeline (reference: pathtrace.metal:5919-6424)
        hit_world = jnp.maximum(rec.t, 0.0) * jnp.sqrt(
            jnp.maximum(dot(cr.ray_d, cr.ray_d), 1e-12))
        cone_at_hit = jnp.maximum(
            cr.cone_width + cr.cone_spread * hit_world, 1e-7)
        passthrough = jnp.zeros(shape, bool)
        diffuse_occlusion = jnp.ones(shape, jnp.float32)
        pbr_emissive = m.emission
        if C.MATERIAL_PBR in types and scene.textures is not None:
            from metal_pathtracer.ops import pbr_textures

            # Per-chunk skip: the texture stage is ~25 gathers/lane and
            # runs on every lane; chunks whose active hits include no PBR
            # triangle lane produce exactly the trivial result (every
            # override is where(pbr_lane, ...), and the alpha-BLEND RNG
            # advance also gates on pbr_lane), so a real lax.cond branch
            # skips the gathers wholesale. Textured objects are spatially
            # localized, so most 256K-lane chunks take the cheap branch.
            pbr_present = jnp.any(active
                                  & (m.mat_type == C.MATERIAL_PBR)
                                  & (rec.prim_type == C.PRIMITIVE_TRIANGLE))

            def _tex_run(opd):
                m_, state_ = opd
                texd = pbr_textures.apply_pbr_textures(
                    scene, m_, rec, wo, cone_at_hit, depth, state_, static,
                    uniforms, ray_d=cr.ray_d)
                return (texd.m, texd.shading_normal,
                        texd.diffuse_occlusion, texd.emissive,
                        texd.passthrough, texd.state)

            def _tex_skip(opd):
                m_, state_ = opd
                return (m_, shading_normal,
                        jnp.ones(shape, jnp.float32),
                        to_working_space(m_.emission, static),
                        jnp.zeros(shape, bool), state_)

            (m, shading_normal, diffuse_occlusion, pbr_emissive,
             tex_pass, state2) = jax.lax.cond(
                pbr_present, _tex_run, _tex_skip, (m, state))
            passthrough = jnp.logical_and(active, tex_pass)
            state = jnp.where(active, state2, state)
        # Dielectric: force geometric normal (reference: pathtrace.metal
        # :5910-5917). Applied AFTER the texture stage: normal maps touch
        # PBR lanes only, and texd.shading_normal passes non-PBR lanes
        # through from the pre-force interpolated normal — applying the
        # force here keeps dielectric lanes geometric either way.
        if C.MATERIAL_DIELECTRIC in types:
            is_dielectric = m.mat_type == C.MATERIAL_DIELECTRIC
            shading_normal = where3(is_dielectric, rec.normal, shading_normal)
        rec = rec.replace(
            shading_normal=shading_normal,
            two_sided=rec.two_sided | ((m.mat_type == C.MATERIAL_PBR)
                                       & (m.pbr_double_sided > 0.5)))

        surface_is_delta = bsdf_ops.material_is_delta(m)

        # ---- first-hit AOVs (reference: pathtrace.metal:6425-6435) -----
        record_aov = active & cr.is_first_hit & jnp.logical_not(passthrough)
        aov_albedo = where3(record_aov, bsdf_ops.material_base_color(m), cr.aov_albedo)
        aov_normal = where3(record_aov, shading_normal, cr.aov_normal)
        is_first_hit = jnp.where(active & jnp.logical_not(passthrough),
                                 False, cr.is_first_hit)

        # ---- PBR emissive additive (reference: pathtrace.metal:6437-6442)
        if C.MATERIAL_PBR in types and not static.debug_specular_only:
            pbr_emit_lane = (active & jnp.logical_not(passthrough)
                             & (m.mat_type == C.MATERIAL_PBR)
                             & jnp.any(pbr_emissive != 0.0, -1)
                             & (rec.front_face | rec.two_sided))
            contrib = bsdf_ops.clamp_firefly_contribution(
                throughput, pbr_emissive, clamp_p)
            radiance = radiance + jnp.where(pbr_emit_lane[..., None], contrib, 0.0)

        # ---- DiffuseLight hit -> emit with MIS, terminate
        #      (reference: pathtrace.metal:6444-6485) --------------------
        light_hit = jnp.logical_and(active, m.mat_type == C.MATERIAL_DIFFUSE_LIGHT)
        if C.MATERIAL_DIFFUSE_LIGHT in types:
            emission = m.emission
            if env_sampling:
                from metal_pathtracer.ops import env as env_ops
                env_mod = env_ops.environment_color(
                    scene.environment, -shading_normal,
                    uniforms.environment_rotation,
                    uniforms.environment_intensity, static)
                use_env = jnp.logical_and(m.emission_env > 0.0, rec.front_face)
                emission = jnp.where(use_env[..., None], emission * env_mod, emission)
            emit_ok = jnp.logical_and(
                jnp.any(emission != 0.0, -1), rec.front_face | rec.two_sided)
            l_mis = jnp.ones(shape, jnp.float32)
            if n_rect_lights > 0:
                light_pdf = _rect_light_pdf_for_hit(scene, rec, cr.ray_o)
                denom = cr.last_pdf + light_pdf
                w = jnp.clip(cr.last_pdf / jnp.maximum(denom, 1e-30),
                             C.MIS_WEIGHT_CLAMP_MIN, C.MIS_WEIGHT_CLAMP_MAX)
                l_mis = jnp.where(jnp.logical_and(use_specular_mis, denom > 0.0),
                                  w, l_mis)
            add = jnp.logical_and(light_hit, emit_ok)
            if static.debug_specular_only:
                add = jnp.zeros_like(add)
            contrib = bsdf_ops.clamp_firefly_contribution(
                throughput, emission * l_mis[..., None], clamp_p)
            radiance = radiance + jnp.where(add[..., None], contrib, 0.0)
        active = jnp.logical_and(active, jnp.logical_not(light_hit))

        # ---- NEE: rect lights (reference: pathtrace.metal:6487-6556) ---
        if n_rect_lights > 0:
            nee_lanes = (active & jnp.logical_not(surface_is_delta)
                         & jnp.logical_not(passthrough))
            nstate, l_dir, l_dist, l_pdf, l_emission, l_valid = \
                _sample_rect_light(scene, rec, state, static, uniforms)
            n_dot_l = jnp.maximum(dot(shading_normal, l_dir), 0.0)
            do_shadow = nee_lanes & l_valid & (l_pdf > 0.0) & (n_dot_l > 0.0)
            shadow_o = intersect.offset_ray_origin(rec, l_dir)
            shadow_max = jnp.where(do_shadow,
                                   jnp.maximum(l_dist - C.EPSILON_T,
                                               C.EPSILON_T), 0.0)
            occluded = intersect.trace_occluded(shadow_o, l_dir, scene,
                                                C.EPSILON_T, shadow_max)
            n_shadow_rays = n_shadow_rays + jnp.sum(do_shadow.astype(jnp.float32))
            ev = bsdf_ops.evaluate_bsdf(
                m, rec.point, shading_normal, wo, l_dir, clamp_p,
                static.sss_mode, diffuse_occlusion,
                static.debug_specular_only, static.material_types)
            max_comp = jnp.max(ev.value, -1)
            w = jnp.ones(shape, jnp.float32)
            denom = l_pdf + ev.pdf
            w = jnp.where(ev.pdf > 0.0,
                          jnp.clip(l_pdf / jnp.maximum(denom, 1e-30),
                                   C.MIS_WEIGHT_CLAMP_MIN, C.MIS_WEIGHT_CLAMP_MAX),
                          w)
            contribution = (l_emission * ev.value * n_dot_l[..., None]
                            * (w / jnp.maximum(l_pdf, 1e-30))[..., None])
            add = (do_shadow & jnp.logical_not(occluded)
                   & jnp.logical_not(ev.is_delta) & jnp.logical_not(ev.is_bssrdf)
                   & (max_comp > 0.0) & jnp.all(jnp.isfinite(contribution), -1))
            clamped = bsdf_ops.clamp_firefly_contribution(
                throughput, contribution, clamp_p)
            radiance = radiance + jnp.where(add[..., None], clamped, 0.0)
            state = jnp.where(nee_lanes, nstate, state)

        # ---- NEE: environment (reference: pathtrace.metal:6558-6648) ---
        if env_sampling:
            from metal_pathtracer.ops import env as env_ops
            nee_lanes = (active & jnp.logical_not(surface_is_delta)
                         & jnp.logical_not(passthrough))
            nstate, e_dir, e_radiance, e_pdf, e_valid = env_ops.sample_environment(
                scene.environment, state, uniforms, static,
                bsdf_ops.environment_lighting_roughness(m))
            n_dot_l = jnp.maximum(dot(shading_normal, e_dir), 0.0)
            do_shadow = nee_lanes & e_valid & (e_pdf > 0.0) & (n_dot_l > 0.0)
            shadow_o = intersect.offset_ray_origin(rec, e_dir)
            shadow_max = jnp.where(do_shadow, C.INFINITY_T, 0.0)
            occluded = intersect.trace_occluded(shadow_o, e_dir, scene,
                                                C.EPSILON_T, shadow_max)
            n_shadow_rays = n_shadow_rays + jnp.sum(do_shadow.astype(jnp.float32))
            ev = bsdf_ops.evaluate_bsdf(
                m, rec.point, shading_normal, wo, e_dir, clamp_p,
                static.sss_mode, diffuse_occlusion,
                static.debug_specular_only, static.material_types)
            max_comp = jnp.max(ev.value, -1)
            w = jnp.ones(shape, jnp.float32)
            denom = e_pdf + ev.pdf
            w = jnp.where(ev.pdf > 0.0,
                          jnp.clip(e_pdf / jnp.maximum(denom, 1e-30),
                                   C.MIS_WEIGHT_CLAMP_MIN, C.MIS_WEIGHT_CLAMP_MAX),
                          w)
            contribution = (e_radiance * ev.value * n_dot_l[..., None]
                            * (w / jnp.maximum(e_pdf, 1e-30))[..., None])
            add = (do_shadow & jnp.logical_not(occluded)
                   & jnp.logical_not(ev.is_delta) & jnp.logical_not(ev.is_bssrdf)
                   & (max_comp > 0.0) & jnp.all(jnp.isfinite(contribution), -1))
            clamped = bsdf_ops.clamp_firefly_contribution(
                throughput, contribution, clamp_p)
            radiance = radiance + jnp.where(add[..., None], clamped, 0.0)
            state = jnp.where(nee_lanes, nstate, state)

        # ---- BSDF sampling (reference: pathtrace.metal:6650-6692) ------
        nstate, smp = bsdf_ops.sample_bsdf(
            m, rec.point, shading_normal, wo, incident, rec.front_face,
            state, clamp_p, static.sss_mode, diffuse_occlusion,
            static.debug_specular_only, static.material_types)
        if C.MATERIAL_SUBSURFACE in types and static.sss_mode == 2:
            # Random-walk SSS takes over on front-face random-walk materials
            # (reference: pathtrace.metal:6652-6678)
            from metal_pathtracer.ops import sss as sss_ops
            rw_lanes = ((m.mat_type == C.MATERIAL_SUBSURFACE)
                        & (m.sss_method >= 0.5) & rec.front_face)
            rw_state, rw_smp = sss_ops.sample_sss_random_walk(
                scene, m, rec, wo, incident, state, clamp_p,
                static.sss_max_steps)
            used_rw = jnp.logical_and(rw_lanes, rw_smp.pdf > 0.0)
            smp = bsdf_ops._select_sample(used_rw, rw_smp, smp)
            nstate = jnp.where(used_rw, rw_state, nstate)
        state = jnp.where(active & jnp.logical_not(passthrough), nstate, state)

        # Alpha pass-through lanes continue as a delta bounce along the
        # unchanged ray (reference: pathtrace.metal:6218-6227)
        if C.MATERIAL_PBR in types:
            pt_smp = bsdf_ops.BsdfSample.invalid(shape)
            pt_smp = pt_smp.replace(
                direction=cr.ray_d,
                weight=jnp.ones(shape + (3,), jnp.float32),
                pdf=jnp.ones(shape, jnp.float32),
                directional_pdf=jnp.ones(shape, jnp.float32),
                is_delta=jnp.ones(shape, bool))
            smp = bsdf_ops._select_sample(passthrough, pt_smp, smp)

        active = jnp.logical_and(active, smp.pdf > 0.0)

        # ---- medium stack push/pop (reference: pathtrace.metal:6694-6708)
        if has_medium:
            push = jnp.logical_and(active, smp.medium_event == 1)
            pop = jnp.logical_and(active, smp.medium_event == -1)
            sigma_in = jnp.maximum(m.dielectric_sigma_a, 0.0)
            slot = jnp.clip(cr.medium_depth, 0, C.MAX_MEDIUM_STACK - 1)
            onehot = (jnp.arange(C.MAX_MEDIUM_STACK) == slot[..., None])
            write = jnp.logical_and(push[..., None], onehot)
            medium_stack = jnp.where(write[..., None], sigma_in[..., None, :],
                                     cr.medium_stack)
            medium_depth = cr.medium_depth
            medium_depth = jnp.where(
                push, jnp.minimum(medium_depth + 1, C.MAX_MEDIUM_STACK),
                medium_depth)
            medium_depth = jnp.where(
                pop, jnp.maximum(medium_depth - 1, 0), medium_depth)
        else:
            medium_stack = cr.medium_stack
            medium_depth = cr.medium_depth

        # ---- next ray origin (reference: pathtrace.metal:6740-6768) ----
        next_origin = intersect.offset_ray_origin(rec, smp.direction)
        if C.MATERIAL_SUBSURFACE in types:
            # BSSRDF exit point (reference: pathtrace.metal:6741-6766)
            exit_normal = smp.exit_normal
            bad = jnp.logical_not(jnp.all(jnp.isfinite(exit_normal), -1)) | \
                (dot(exit_normal, exit_normal) <= 0.0)
            exit_normal = where3(bad, rec.normal, exit_normal)
            exit_normal = safe_normalize(exit_normal)
            sign = jnp.where(dot(smp.direction, exit_normal) >= 0.0, 1.0, -1.0)
            exit_o = smp.exit_point + exit_normal * (
                sign * C.RAY_ORIGIN_EPSILON)[..., None]
            exit_o = exit_o + exit_normal * (C.RAY_ORIGIN_EPSILON * 32.0)
            dir_n = safe_normalize(smp.direction)
            exit_o = exit_o + dir_n * (C.RAY_ORIGIN_EPSILON * 32.0)
            next_origin = where3(smp.has_exit_point, exit_o, next_origin)

        # ---- specular NEE / MNEE delta chains
        #      (reference: pathtrace.metal:6770-7235) --------------------
        next_specular_depth = jnp.where(smp.is_delta, cr.specular_depth + 1, 0)
        if (static.enable_specular_nee or static.enable_mnee) and \
                (env_sampling or n_rect_lights > 0):
            from metal_pathtracer.ops import specnee
            is_dielectric_lane = m.mat_type == C.MATERIAL_DIELECTRIC
            chain_add, chain_scene, chain_shadow = \
                specnee.delta_chain_estimators(
                    scene, uniforms, static, clamp_p, throughput, smp,
                    next_origin, rec, shading_normal, next_specular_depth,
                    state, active & jnp.logical_not(passthrough),
                    is_dielectric_lane)
            radiance = radiance + chain_add
            n_rays = n_rays + chain_scene
            n_shadow_rays = n_shadow_rays + chain_shadow

        # ---- throughput update (reference: pathtrace.metal:7237-7248) --
        throughput_next = throughput * smp.weight
        throughput_next = bsdf_ops.clamp_path_throughput(throughput_next, clamp_p)
        finite_tp = jnp.all(jnp.isfinite(throughput_next), -1)
        max_tp = jnp.max(throughput_next, -1)
        active = active & finite_tp & (max_tp > 0.0)

        # ---- env LOD carry (reference: pathtrace.metal:7249-7261) ------
        env_lod = cr.env_lod
        env_lod_active = cr.env_lod_active
        if env_sampling and scene.environment is not None \
                and len(scene.environment.mips) > 0:
            from metal_pathtracer.ops import env as env_ops
            next_active = jnp.logical_and(smp.lobe_type == 1,
                                          jnp.logical_not(smp.is_delta))
            next_lod = env_ops.environment_lod_from_roughness(
                smp.lobe_roughness, scene.environment)
            env_lod = jnp.where(active & next_active, next_lod, 0.0)
            env_lod_active = active & next_active
        else:
            env_lod = jnp.zeros(shape, jnp.float32)
            env_lod_active = jnp.zeros(shape, bool)

        # ---- bookkeeping + Russian roulette
        #      (reference: pathtrace.metal:7270-7280) --------------------
        last_pdf = jnp.where(smp.directional_pdf > 0.0, smp.directional_pdf, smp.pdf)
        specular_depth = jnp.where(smp.is_delta, cr.specular_depth + 1, 0)
        del next_specular_depth  # alias of specular_depth used by the chains

        # ---- ray cone update (reference: pathtrace.metal:7263-7269) ----
        cone_width = jnp.where(active, cone_at_hit, cr.cone_width)
        cone_spread = jnp.where(
            active,
            jnp.minimum(cr.cone_spread + bsdf_ops.bsdf_cone_spread_increment(
                smp.lobe_type, smp.lobe_roughness, smp.is_delta), 1.5),
            cr.cone_spread)

        state_rr = state
        if static.use_russian_roulette:
            do_rr = active & (depth >= 5) & jnp.logical_not(passthrough)
            nstate, xi = rng_ops.rand_uniform(state)
            cont_p = jnp.clip(max_tp, 0.05, 0.95)
            survive = xi <= cont_p
            throughput_next = jnp.where(
                (do_rr & survive)[..., None], throughput_next / cont_p[..., None],
                throughput_next)
            active = jnp.where(do_rr, active & survive, active)
            state_rr = jnp.where(do_rr, nstate, state)

        # ---- commit (dead lanes keep their entry values) ---------------
        keep = alive0

        def sel(new, old):
            mask = keep.reshape(keep.shape + (1,) * (new.ndim - keep.ndim))
            return jnp.where(mask, new, old)

        if records is not None:
            # debug probe: one record per bounce (reference ring buffer,
            # MetalShaderTypes.h:270-287 / pathtrace.metal:258-492)
            f32 = lambda v: v.astype(jnp.float32)
            row = jnp.stack([
                f32(rec.hit), rec.t, f32(rec.prim_type), f32(rec.prim_index),
                f32(rec.mesh_index), f32(rec.material),
                throughput[..., 0], throughput[..., 1], throughput[..., 2],
                radiance[..., 0], radiance[..., 1], radiance[..., 2],
                f32(medium_depth), f32(smp.medium_event), smp.pdf,
                f32(smp.is_delta)], axis=-1)
            live = alive0.reshape(alive0.shape + (1,))
            records = records.at[depth].set(jnp.where(live, row, 0.0))

        new_carry = PathCarry(
            state=sel(state_rr, cr.state),
            ray_o=sel(next_origin, cr.ray_o),
            ray_d=sel(smp.direction, cr.ray_d),
            throughput=sel(throughput_next, cr.throughput),
            radiance=sel(radiance, cr.radiance),
            alive=jnp.logical_and(alive0, active),
            last_pdf=sel(last_pdf, cr.last_pdf),
            last_delta=sel(smp.is_delta, cr.last_delta),
            prev_valid=sel(rec.hit, cr.prev_valid),
            prev_mesh=sel(jnp.where(rec.prim_type == C.PRIMITIVE_TRIANGLE,
                                    rec.mesh_index, -1), cr.prev_mesh),
            prev_prim=sel(jnp.where(rec.prim_type == C.PRIMITIVE_TRIANGLE,
                                    rec.prim_index, -1), cr.prev_prim),
            medium_stack=sel(medium_stack, cr.medium_stack),
            medium_depth=sel(medium_depth, cr.medium_depth),
            is_first_hit=sel(is_first_hit, cr.is_first_hit),
            aov_albedo=sel(aov_albedo, cr.aov_albedo),
            aov_normal=sel(aov_normal, cr.aov_normal),
            specular_depth=sel(specular_depth, cr.specular_depth),
            env_lod=sel(env_lod, cr.env_lod),
            env_lod_active=sel(env_lod_active, cr.env_lod_active),
            n_rays=n_rays,
            n_shadow_rays=n_shadow_rays,
            cone_width=sel(cone_width, cr.cone_width),
            cone_spread=sel(cone_spread, cr.cone_spread),
        )
        if records is not None:
            return new_carry, records
        return new_carry

    # while-loop over depth: ends as soon as every lane has terminated
    # (the wavefront analogue of the megakernel's per-thread break)
    if record_probe:
        records0 = jnp.zeros((static.max_depth,) + shape + (len(PROBE_FIELDS),),
                             jnp.float32)

        def probe_cond(state):
            depth, cr, _ = state
            return jnp.logical_and(depth < static.max_depth,
                                   jnp.any(cr.alive))

        def probe_body(state):
            depth, cr, records = state
            cr, records = body(depth, cr, records)
            return depth + 1, cr, records

        _, carry, records = jax.lax.while_loop(
            probe_cond, probe_body, (jnp.int32(0), carry, records0))
        stats = {"rays": carry.n_rays, "shadow_rays": carry.n_shadow_rays}
        return (carry.state, carry.radiance, carry.aov_albedo,
                carry.aov_normal, stats, records)

    def loop_cond(state):
        depth, cr = state
        return jnp.logical_and(depth < static.max_depth, jnp.any(cr.alive))

    def loop_body(state):
        depth, cr = state
        return depth + 1, body(depth, cr)

    _, carry = jax.lax.while_loop(loop_cond, loop_body, (jnp.int32(0), carry))
    stats = {"rays": carry.n_rays, "shadow_rays": carry.n_shadow_rays}
    return carry.state, carry.radiance, carry.aov_albedo, carry.aov_normal, stats


def integrate_pixels(scene: SceneArrays, uniforms: Uniforms,
                     static: StaticConfig, x, y, prev_count,
                     frame_offset=None):
    """One sample for a batch of pixels (the kernel entry,
    reference: pathtrace.metal:9698-9815).

    `frame_offset` (per-lane u32, optional) shifts the dispatch-scalar
    frame/sample counters per lane — cross-sample batching traces several
    consecutive sample ordinals of the same pixel strip in one wavefront
    (renderer/frame.py), and each lane must reproduce exactly the seed its
    ordinal would get from the reference's per-dispatch recipe
    (pathtrace.metal:9735-9740).

    Returns (sample_rgb, aov_albedo, aov_normal) for the lanes.
    """
    frame_index = uniforms.frame_index
    sample_count = uniforms.sample_count
    if frame_offset is not None:
        frame_index = frame_index + frame_offset
        sample_count = sample_count + frame_offset
    seed = rng_ops.make_seed(uniforms.fixed_rng_seed, frame_index,
                             x, y, sample_count, prev_count)
    state = seed
    state, origin, direction = camera_ops.generate_primary_rays(
        uniforms.camera, x, y, static.width, static.height, state)
    state, radiance, aov_albedo, aov_normal, stats = trace_paths(
        scene, uniforms, static, state, origin, direction)

    finite = jnp.all(jnp.isfinite(radiance), -1)
    sample = jnp.where(finite[..., None], jnp.maximum(radiance, 0.0), 0.0)
    return sample, aov_albedo, aov_normal, stats
