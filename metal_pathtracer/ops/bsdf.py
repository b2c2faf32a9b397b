"""BSDF library: evaluation and sampling for the material zoo.

Vectorized re-implementation of the reference's BSDF dispatchers
(reference: shaders/pathtrace.metal evaluate_bsdf:4950-5136 and
sample_bsdf:5136-5717). Instead of a per-thread `switch`, every material
type present in the scene (a jit-static set) is evaluated for the whole
wavefront and lanes select their own type's result — absent types compile
to nothing, the counterpart of shader specialization.

RNG parity: each lane's uint32 state advances exactly as many draws as the
branch taken would in the reference, because the selected branch's output
state is chosen per lane.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from metal_pathtracer import constants as C
from metal_pathtracer.ops import rng as rng_ops
from metal_pathtracer.ops.vecmath import (
    dot,
    dot3,
    luminance,
    normalize,
    reflect,
    refract,
    safe_normalize,
    to_world,
    where3,
)
from metal_pathtracer.utils import pytree

Array = jax.Array
PI = 3.14159265358979323846


# ---------------------------------------------------------------------------
# Firefly / clamp params (reference: pathtrace.metal make_firefly_params)
# ---------------------------------------------------------------------------

class ClampParams(NamedTuple):
    clamp_factor: Array
    clamp_floor: Array
    throughput_clamp: Array
    specular_tail_base: Array
    specular_tail_roughness_scale: Array
    min_specular_pdf: Array
    max_contribution: Array
    enabled: Array


def make_clamp_params(uniforms) -> ClampParams:
    return ClampParams(
        clamp_factor=uniforms.firefly_clamp_factor,
        clamp_floor=uniforms.firefly_clamp_floor,
        throughput_clamp=uniforms.throughput_clamp,
        specular_tail_base=uniforms.specular_tail_clamp_base,
        specular_tail_roughness_scale=uniforms.specular_tail_clamp_roughness_scale,
        min_specular_pdf=uniforms.min_specular_pdf,
        max_contribution=uniforms.firefly_clamp_max_contribution,
        enabled=uniforms.firefly_clamp_enabled,
    )


def clamp_firefly_contribution(throughput, contribution, p: ClampParams):
    """(reference: pathtrace.metal clamp_firefly_contribution)"""
    combined = throughput * contribution
    finite = jnp.all(jnp.isfinite(combined), -1)
    positive = jnp.maximum(combined, 0.0)

    lum = luminance(positive)
    tp_lum = luminance(jnp.maximum(throughput, 0.0))
    max_lum = jnp.maximum(tp_lum * p.clamp_factor, p.clamp_floor)
    max_lum = jnp.where(p.max_contribution > 0.0,
                        jnp.maximum(max_lum, p.max_contribution), max_lum)
    scale = jnp.where((lum > max_lum) & (lum > 0.0),
                      max_lum / jnp.maximum(lum, 1e-6), 1.0)
    clamped = jnp.maximum(combined * scale[..., None], 0.0)
    out = jnp.where(p.enabled < 0.5, positive, clamped)
    return where3(finite, out, jnp.zeros_like(out))


def clamp_path_throughput(throughput, p: ClampParams):
    """(reference: pathtrace.metal clamp_path_throughput)"""
    finite = jnp.all(jnp.isfinite(throughput), -1)
    positive = jnp.maximum(throughput, 0.0)
    lum = luminance(positive)
    scale = jnp.where((lum > p.throughput_clamp) & (lum > 0.0),
                      p.throughput_clamp / jnp.maximum(lum, 1e-6), 1.0)
    active = (p.enabled >= 0.5) & (p.throughput_clamp > 0.0)
    out = jnp.where(active, scale[..., None] * throughput, throughput)
    return where3(finite, out, jnp.zeros_like(out))


def clamp_specular_pdf(pdf, p: ClampParams):
    """(reference: pathtrace.metal clamp_specular_pdf)"""
    pdf = jnp.where(jnp.isfinite(pdf), pdf, 0.0)
    pdf = jnp.maximum(pdf, 0.0)
    raised = jnp.where(p.min_specular_pdf > 0.0,
                       jnp.maximum(pdf, p.min_specular_pdf), pdf)
    return jnp.where(pdf > 0.0, raised, 0.0)


def clamp_specular_tail(value, roughness, f0, p: ClampParams):
    """(reference: pathtrace.metal clamp_specular_tail)"""
    finite = jnp.all(jnp.isfinite(value), -1)
    positive = jnp.maximum(value, 0.0)
    strength = jnp.maximum(jnp.max(f0, axis=-1), 1e-3)
    limit = (p.specular_tail_base
             + p.specular_tail_roughness_scale * roughness) * strength
    limit = jnp.maximum(limit, p.clamp_floor)
    lum = luminance(positive)
    scale = jnp.where((lum > limit) & (lum > 0.0),
                      limit / jnp.maximum(lum, 1e-6), 1.0)
    active = (p.enabled >= 0.5) & (
        (p.specular_tail_base > 0.0) | (p.specular_tail_roughness_scale > 0.0))
    out = jnp.where(active, positive * scale[..., None], positive)
    return where3(finite, out, jnp.zeros_like(out))


# ---------------------------------------------------------------------------
# Fresnel / GGX microfacet helpers (reference: pathtrace.metal:3645-3911)
# ---------------------------------------------------------------------------

def schlick_weight(cos_theta):
    m = jnp.clip(1.0 - cos_theta, 0.0, 1.0)
    return m * m * m * m * m


def schlick_fresnel(f0, cos_theta):
    return f0 + (1.0 - f0) * schlick_weight(cos_theta)[..., None]


def schlick_fresnel_scalar(f0, cos_theta):
    return f0 + (1.0 - f0) * schlick_weight(cos_theta)


def fresnel_dielectric_exact(cos_theta_i, eta_i, eta_t):
    """Exact unpolarized dielectric Fresnel, returning (Fr, cosThetaT)
    (reference: pathtrace.metal fresnel_dielectric_exact:3645-3674)."""
    cos_theta_i = jnp.clip(cos_theta_i, -1.0, 1.0)
    abs_cos = jnp.abs(cos_theta_i)
    sin2_i = jnp.maximum(0.0, 1.0 - abs_cos * abs_cos)
    eta = eta_i / eta_t
    sin2_t = eta * eta * sin2_i
    tir = sin2_t >= 1.0

    cos_t = jnp.sqrt(jnp.maximum(1.0 - sin2_t, 0.0))
    ei_ci = eta_i * abs_cos
    et_ct = eta_t * cos_t
    rs = (ei_ci - et_ct) / (ei_ci + et_ct)
    rp = (eta_t * abs_cos - eta_i * cos_t) / (eta_t * abs_cos + eta_i * cos_t)
    fr = 0.5 * (rs * rs + rp * rp)
    fr = jnp.where(tir, 1.0, fr)
    cos_t = jnp.where(tir, 0.0, cos_t)
    return fr, cos_t


def fresnel_conductor(cos_theta_i, eta, k):
    """(reference: pathtrace.metal fresnel_conductor:3677-3698)"""
    cos_theta_i = jnp.clip(cos_theta_i, -1.0, 1.0)
    cos2 = (cos_theta_i * cos_theta_i)[..., None]
    sin2 = jnp.maximum(0.0, 1.0 - cos2)
    eta2 = eta * eta
    k2 = k * k
    t0 = eta2 - k2 - sin2
    a2b2 = jnp.sqrt(jnp.maximum(t0 * t0 + 4.0 * eta2 * k2, 0.0))
    a = jnp.sqrt(jnp.maximum(0.5 * (a2b2 + t0), 0.0))
    term1 = a2b2 + cos2
    term2 = 2.0 * cos_theta_i[..., None] * a
    rs = (term1 - term2) / (term1 + term2)
    term3 = cos2 * a2b2 + sin2 * sin2
    term4 = term2 * sin2
    rp = (term3 - term4) / (term3 + term4)
    return jnp.clip(0.5 * (rs * rs + rp * rp), 0.0, 1.0)


def ggx_lambda(alpha, cos_theta):
    abs_cos = jnp.abs(cos_theta)
    sin_theta = jnp.sqrt(jnp.maximum(0.0, 1.0 - abs_cos * abs_cos))
    tan_theta = sin_theta / jnp.maximum(abs_cos, 1e-20)
    a = alpha * tan_theta
    lam = (-1.0 + jnp.sqrt(1.0 + a * a)) * 0.5
    return jnp.where((abs_cos <= 0.0) | (sin_theta == 0.0), 0.0, lam)


def ggx_g1(alpha, cos_theta):
    return 1.0 / (1.0 + ggx_lambda(alpha, cos_theta))


def ggx_d(alpha, normal, wh, clamp_negative=False):
    """GGX D of half vector wh about normal. The 1 - cos^2 of the textbook
    denominator cos^2 (a^2 - 1) + 1 is taken as |normal x wh|^2: near the
    normal, where a smooth lobe puts its half vectors, cos is within a few
    float32 ulps of 1 and 1 - cos^2 keeps no significant digits, while
    the cross product keeps full relative precision. clamp_negative
    treats a half vector below the surface as cos = 0."""
    c = dot(normal, wh)
    nxh = jnp.cross(normal, wh)
    s2 = dot(nxh, nxh)
    if clamp_negative:
        s2 = jnp.where(c < 0.0, 1.0, s2)
        c = jnp.maximum(c, 0.0)
    a2 = alpha * alpha
    denom = s2 + c * c * a2
    return a2 / (PI * denom * denom)


def ggx_pdf(alpha, normal, wo, wi):
    wh = safe_normalize(wo + wi)
    cos_h = dot(normal, wh)
    dot_wo_wh = dot(wo, wh)
    cos_o = dot(normal, wo)
    d = ggx_d(alpha, normal, wh)
    g1 = ggx_g1(alpha, cos_o)
    pdf = d * g1 * cos_h / (4.0 * jnp.maximum(dot_wo_wh, 1e-6))
    return jnp.where((cos_o <= 0.0) | (cos_h <= 0.0) | (dot_wo_wh <= 0.0), 0.0, pdf)


def to_local(v, normal):
    from metal_pathtracer.ops.vecmath import build_onb
    tangent, bitangent = build_onb(normal)
    return jnp.stack([dot(v, tangent), dot(v, bitangent), dot(v, normal)], -1)


def sample_ggx_vndf(normal, wo, roughness, state):
    """Heitz VNDF sampling (reference: pathtrace.metal sample_ggx_vndf:3770-3797).

    Consumes exactly 2 uniforms per lane like the reference.
    """
    wo_local = to_local(safe_normalize(wo), normal)
    woz = jnp.maximum(wo_local[..., 2], 1e-6)
    wo_local = jnp.concatenate([wo_local[..., :2], woz[..., None]], -1)
    alpha = jnp.maximum(roughness * roughness, 1e-4)[..., None]
    vh = safe_normalize(jnp.concatenate(
        [alpha * wo_local[..., :2], wo_local[..., 2:3]], -1))

    lensq = vh[..., 0] ** 2 + vh[..., 1] ** 2
    t1 = jnp.where(
        (lensq > 0.0)[..., None],
        jnp.stack([-vh[..., 1], vh[..., 0], jnp.zeros_like(lensq)], -1)
        * jax.lax.rsqrt(jnp.maximum(lensq, 1e-38))[..., None],
        jnp.broadcast_to(jnp.asarray([1.0, 0.0, 0.0], vh.dtype), vh.shape))
    t2 = jnp.cross(vh, t1)

    state, u1 = rng_ops.rand_uniform(state)
    state, u2 = rng_ops.rand_uniform(state)
    r = jnp.sqrt(u1)
    phi = 2.0 * PI * u2
    p1 = r * jnp.cos(phi)
    p2 = r * jnp.sin(phi)
    s = 0.5 * (1.0 + vh[..., 2])
    p2_adj = (1.0 - s) * jnp.sqrt(jnp.maximum(0.0, 1.0 - p1 * p1)) + s * p2
    p3 = jnp.sqrt(jnp.maximum(0.0, 1.0 - p1 * p1 - p2_adj * p2_adj))

    nh = p1[..., None] * t1 + p2_adj[..., None] * t2 + p3[..., None] * vh
    ne = safe_normalize(jnp.concatenate(
        [alpha * nh[..., :2], jnp.maximum(nh[..., 2:3], 0.0)], -1))
    return state, safe_normalize(to_world(ne, normal))


def dfg_approx(roughness, nov):
    """Karis split-sum DFG approximation (reference: pathtrace.metal dfg_approx)."""
    c0 = jnp.asarray([-1.0, -0.0275, -0.572, 0.022], jnp.float32)
    c1 = jnp.asarray([1.0, 0.0425, 1.04, -0.04], jnp.float32)
    r = roughness[..., None] * c0 + c1
    a004 = jnp.minimum(r[..., 0] * r[..., 0],
                       jnp.exp2(-9.28 * nov)) * r[..., 0] + r[..., 1]
    x = -1.04 * a004 + r[..., 2]
    y = 1.04 * a004 + r[..., 3]
    return x, y


def specular_energy_compensation(f0, roughness, nov):
    """Multiple-scattering energy compensation
    (reference: pathtrace.metal specular_energy_compensation)."""
    nov_c = jnp.clip(nov, 0.0, 1.0)
    dfg_x, dfg_y = dfg_approx(roughness, nov_c)
    fss = jnp.clip(f0 * dfg_x[..., None] + dfg_y[..., None], 0.0, 0.99)
    favg = f0 + (1.0 - f0) * C.SCHLICK_AVERAGE_FACTOR
    one_minus_fss = jnp.clip(1.0 - fss, 0.0, 1.0)
    denom = jnp.maximum(1.0 - favg * one_minus_fss, 1e-3)
    fms = (favg * one_minus_fss) / denom
    scale = (fss + fms) / jnp.maximum(fss, 1e-4)
    return jnp.clip(scale, 1.0, 2.0)


# ---------------------------------------------------------------------------
# Material lanes: per-lane gathered material parameters
# ---------------------------------------------------------------------------

@pytree.dataclass
class MatLanes:
    """MaterialsSoA rows gathered onto wavefront lanes."""

    base_color: Array
    roughness: Array
    mat_type: Array
    eta: Array
    coat_ior: Array
    thin: Array
    emission: Array
    emission_env: Array
    conductor_eta: Array
    conductor_k: Array
    has_conductor: Array
    coat_roughness: Array
    coat_thickness: Array
    coat_sample_weight: Array
    coat_fresnel_avg: Array
    coat_tint: Array
    coat_absorption: Array
    dielectric_sigma_a: Array
    sss_sigma_a: Array
    sss_sigma_override: Array
    sss_sigma_s: Array
    sss_g: Array
    sss_mfp: Array
    sss_method: Array
    sss_coat: Array
    carpaint_base_metallic: Array
    carpaint_base_roughness: Array
    carpaint_flake_scale: Array
    carpaint_flake_reflectance: Array
    carpaint_flake_sample_weight: Array
    carpaint_flake_roughness: Array
    carpaint_flake_anisotropy: Array
    carpaint_flake_normal_strength: Array
    carpaint_base_eta: Array
    carpaint_base_k: Array
    carpaint_has_base_conductor: Array
    carpaint_base_tint: Array
    pbr_metallic: Array
    pbr_roughness: Array
    pbr_occlusion_strength: Array
    pbr_normal_scale: Array
    pbr_alpha: Array
    pbr_alpha_cutoff: Array
    pbr_transmission: Array
    pbr_alpha_mode: Array
    pbr_double_sided: Array
    pbr_thickness: Array
    texture_indices: Array
    texture_uv_set: Array
    texture_transform: Array
    material_flags: Array


def gather_material(materials, index) -> MatLanes:
    """Gather MaterialsSoA rows at per-lane indices.

    All ~50 fields are concatenated into one (M, K) table (loop-invariant,
    M <= 512 so the concat is trivial and XLA hoists it) and fetched with
    ONE row gather instead of ~50 narrow per-field gathers. Integer fields
    round-trip exactly through f32 (all are small ids/flags).
    """
    idx = jnp.clip(index, 0, materials.count - 1)
    fields = list(MatLanes.__dataclass_fields__)
    cols = []
    layout = []
    off = 0
    for f in fields:
        a = getattr(materials, f)
        flat = a.reshape(a.shape[0], -1)
        width = flat.shape[1]
        layout.append((f, off, width, a.dtype, a.shape[1:]))
        cols.append(flat.astype(jnp.float32))
        off += width
    packed = jnp.concatenate(cols, axis=1)          # (M, K)
    m_count = packed.shape[0]
    if m_count == 1:
        # single-material scene: a broadcast, not a gather
        rows = jnp.broadcast_to(packed[0], index.shape + (packed.shape[1],))
    else:
        rows = packed[idx]                          # one gather
    out = {}
    for f, lo, width, dtype, tail in layout:
        v = rows[..., lo:lo + width].reshape(index.shape + tail)
        out[f] = v if dtype == jnp.float32 else v.astype(dtype)
    return MatLanes(**out)


def material_base_color(m: MatLanes):
    return jnp.clip(m.base_color, 0.0, 1.0)


def material_is_delta(m: MatLanes):
    """(reference: pathtrace.metal material_is_delta)"""
    rough = jnp.clip(m.roughness, 0.0, 1.0)
    return ((m.mat_type == C.MATERIAL_DIELECTRIC)
            | ((m.mat_type == C.MATERIAL_METAL) & (rough <= 1e-3))
            | ((m.mat_type == C.MATERIAL_PBR) & (rough <= 1e-3)))


def material_has_conductor_ior(m: MatLanes):
    return ((m.has_conductor > 0.0)
            | jnp.any(m.conductor_eta > 0.0, -1)
            | jnp.any(m.conductor_k > 0.0, -1))


def conductor_f0(m: MatLanes):
    fc = fresnel_conductor(jnp.ones(m.roughness.shape, jnp.float32),
                           m.conductor_eta, m.conductor_k)
    return where3(material_has_conductor_ior(m), fc, material_base_color(m))


def plastic_coat_ior(m: MatLanes):
    return jnp.maximum(m.eta, 1.0)


def plastic_coat_roughness(m: MatLanes):
    return jnp.maximum(jnp.clip(m.coat_roughness, 0.0, 1.0), 1e-3)


def plastic_coat_f0(m: MatLanes):
    eta = plastic_coat_ior(m)
    ratio = (eta - 1.0) / jnp.maximum(eta + 1.0, 1e-6)
    return jnp.clip(ratio * ratio, 0.0, 0.999)


def plastic_specular_tint(m: MatLanes):
    """(reference: pathtrace.metal plastic_specular_tint)"""
    tint = jnp.clip(m.coat_tint, 0.0, 1.0)
    thickness = jnp.maximum(m.coat_thickness, 0.0)
    absorption = jnp.maximum(m.coat_absorption, 0.0)
    attenuated = jnp.clip(tint * jnp.exp(-absorption * thickness[..., None]), 0.0, 1.0)
    skip = (thickness <= 0.0) | jnp.all(absorption <= 1e-6, -1)
    return where3(skip, tint, attenuated)


def plastic_diffuse_transmission(m: MatLanes, cos_i, cos_o):
    """(reference: pathtrace.metal plastic_diffuse_transmission)"""
    thickness = jnp.maximum(m.coat_thickness, 0.0)
    tint = jnp.clip(m.coat_tint, 0.0, 1.0)
    absorption = jnp.maximum(m.coat_absorption, 0.0)
    safe_i = jnp.maximum(cos_i, 1e-3)
    safe_o = jnp.maximum(cos_o, 1e-3)
    att_i = jnp.exp(-absorption * (thickness / safe_i)[..., None])
    att_o = jnp.exp(-absorption * (thickness / safe_o)[..., None])
    full = jnp.clip(tint * att_i * att_o, 0.0, 1.0)
    return where3(thickness <= 0.0, tint, full)


def environment_lighting_roughness(m: MatLanes):
    """(reference: pathtrace.metal environment_lighting_roughness)"""
    rough = jnp.clip(m.roughness, 0.0, 1.0)
    out = jnp.ones_like(rough)
    out = jnp.where((m.mat_type == C.MATERIAL_METAL)
                    | (m.mat_type == C.MATERIAL_PBR), rough, out)
    out = jnp.where(m.mat_type == C.MATERIAL_PLASTIC,
                    jnp.clip(plastic_coat_roughness(m), 0.0, 1.0), out)
    out = jnp.where(m.mat_type == C.MATERIAL_CARPAINT,
                    jnp.clip(m.carpaint_base_roughness, 0.0, 1.0), out)
    return out


def lambert_pdf(normal, direction):
    d = normalize(direction)
    cos_t = jnp.maximum(dot(normal, d), 0.0)
    return jnp.where(cos_t > 0.0, cos_t / PI, 0.0)


# ---------------------------------------------------------------------------
# Sample / eval results
# ---------------------------------------------------------------------------

@pytree.dataclass
class BsdfSample:
    direction: Array       # (N,3)
    weight: Array          # (N,3) — f * cos / pdf, pre-divided
    pdf: Array             # (N,)
    directional_pdf: Array  # (N,)
    is_delta: Array        # (N,) bool
    medium_event: Array    # (N,) i32: +1 enter medium, -1 exit
    lobe_type: Array       # (N,) i32: 0 diffuse, 1 glossy/specular
    lobe_roughness: Array  # (N,)
    is_bssrdf: Array       # (N,) bool
    has_exit_point: Array  # (N,) bool
    exit_point: Array      # (N,3)
    exit_normal: Array     # (N,3)

    @classmethod
    def invalid(cls, shape):
        z = jnp.zeros(shape, jnp.float32)
        z3 = jnp.zeros(shape + (3,), jnp.float32)
        zi = jnp.zeros(shape, jnp.int32)
        zb = jnp.zeros(shape, bool)
        return cls(direction=z3, weight=z3, pdf=z, directional_pdf=z,
                   is_delta=zb, medium_event=zi, lobe_type=zi,
                   lobe_roughness=z, is_bssrdf=zb, has_exit_point=zb,
                   exit_point=z3, exit_normal=z3)


class BsdfEval(NamedTuple):
    value: Array        # (N,3)
    pdf: Array          # (N,)
    directional_pdf: Array
    is_delta: Array     # (N,) bool
    is_bssrdf: Array    # (N,) bool


def _select_sample(mask, a: BsdfSample, b: BsdfSample) -> BsdfSample:
    """Lanes where mask take a, else b."""
    return jax.tree_util.tree_map(
        lambda x, y: jnp.where(
            mask.reshape(mask.shape + (1,) * (x.ndim - mask.ndim)), x, y), a, b)


# ---------------------------------------------------------------------------
# Per-type samplers (each consumes RNG like its reference branch)
# ---------------------------------------------------------------------------

def _sample_lambert(m, normal, state, diffuse_occlusion):
    """case 0 (reference: pathtrace.metal:5163-5196)"""
    shape = normal.shape[:-1]
    state, local = rng_ops.sample_cosine_hemisphere(state)
    wi = safe_normalize(to_world(local, normal))
    cos_i = dot(normal, wi)
    pdf = lambert_pdf(normal, wi)
    albedo = material_base_color(m) * jnp.clip(diffuse_occlusion, 0.0, 1.0)[..., None]
    f = albedo / PI
    weight = jnp.maximum(f * (cos_i / jnp.maximum(pdf, 1e-20))[..., None], 0.0)
    ok = (cos_i > 0.0) & (pdf > 0.0) & jnp.all(jnp.isfinite(weight), -1)

    out = BsdfSample.invalid(shape)
    out = out.replace(
        direction=where3(ok, wi, out.direction),
        weight=where3(ok, weight, out.weight),
        pdf=jnp.where(ok, pdf, 0.0),
        directional_pdf=jnp.where(ok, pdf, 0.0),
        lobe_roughness=jnp.where(ok, 1.0, 0.0))
    return state, out


def _sample_metal(m, normal, wo, incident, state, clamp_p):
    """case 1 (reference: pathtrace.metal:5197-5284)"""
    shape = normal.shape[:-1]
    roughness = jnp.clip(m.roughness, 0.0, 1.0)
    f0 = conductor_f0(m)
    has_ior = material_has_conductor_ior(m)
    smooth = roughness <= 1e-3

    # --- delta (mirror) branch: no RNG draws
    wi_d = reflect(incident, normal)
    cos_i_d = dot(normal, wi_d)
    cos_o = dot(normal, wo)
    cos_t = jnp.maximum(cos_o, 0.0)
    f_delta = where3(has_ior, fresnel_conductor(cos_t, m.conductor_eta, m.conductor_k),
                     schlick_fresnel(f0, cos_t))
    delta_ok = cos_i_d > 0.0

    # --- rough GGX branch: 2 RNG draws
    state_r, wh = sample_ggx_vndf(normal, wo, roughness, state)
    alpha = roughness * roughness
    wi_r = safe_normalize(reflect(-wo, wh))
    cos_i = dot(normal, wi_r)
    dot_wo_wh = dot(wo, wh)
    d = ggx_d(alpha, normal, wh)
    g = ggx_g1(alpha, cos_o) * ggx_g1(alpha, cos_i)
    f_rough = where3(has_ior,
                     fresnel_conductor(dot(wi_r, wh), m.conductor_eta, m.conductor_k),
                     schlick_fresnel(f0, dot(wi_r, wh)))
    denom = 4.0 * cos_o * cos_i
    f_val = f_rough * (d * g / jnp.maximum(denom, 1e-6))[..., None]
    f_val = f_val * specular_energy_compensation(f0, roughness, cos_o)
    f_val = clamp_specular_tail(f_val, roughness, f0, clamp_p)
    pdf_raw = ggx_pdf(alpha, normal, wo, wi_r)
    pdf = clamp_specular_pdf(pdf_raw, clamp_p)
    weight = jnp.maximum(f_val * (cos_i / jnp.maximum(pdf, 1e-20))[..., None], 0.0)
    rough_ok = ((dot(wh, normal) > 0.0) & jnp.all(jnp.isfinite(wi_r), -1)
                & (cos_i > 0.0) & (cos_o > 0.0) & (dot_wo_wh > 0.0)
                & (pdf_raw > 0.0) & jnp.all(jnp.isfinite(weight), -1))

    out = BsdfSample.invalid(shape)
    # rough lanes
    rough_valid = jnp.logical_and(~smooth, rough_ok)
    out = out.replace(
        direction=where3(rough_valid, wi_r, out.direction),
        weight=where3(rough_valid, weight, out.weight),
        pdf=jnp.where(rough_valid, pdf, out.pdf),
        directional_pdf=jnp.where(rough_valid, pdf, out.directional_pdf),
        lobe_type=jnp.where(rough_valid, 1, out.lobe_type),
        lobe_roughness=jnp.where(rough_valid, roughness, out.lobe_roughness))
    # delta lanes
    delta_valid = jnp.logical_and(smooth, delta_ok)
    out = out.replace(
        direction=where3(delta_valid, wi_d, out.direction),
        weight=where3(delta_valid, f_delta, out.weight),
        pdf=jnp.where(delta_valid, 1.0, out.pdf),
        directional_pdf=jnp.where(delta_valid, 1.0, out.directional_pdf),
        is_delta=jnp.where(delta_valid, True, out.is_delta),
        lobe_type=jnp.where(delta_valid, 1, out.lobe_type),
        lobe_roughness=jnp.where(delta_valid, roughness, out.lobe_roughness))
    # delta branch consumes no RNG
    state = jnp.where(smooth, state, state_r)
    return state, out


def _sample_dielectric(m, normal, incident, front_face, state):
    """case 2 (reference: pathtrace.metal:5647-5695)"""
    shape = normal.shape[:-1]
    is_thin = (m.mat_type == C.MATERIAL_DIELECTRIC) & (m.thin > 0.5)
    ref_idx = jnp.maximum(m.eta, 1.0)
    inside = jnp.logical_and(~is_thin, ~front_face)
    eta_i = jnp.where(inside, ref_idx, 1.0)
    eta_t = jnp.where(inside, 1.0, ref_idx)
    relative_eta = eta_i / eta_t
    unit_dir = incident
    cos_o = jnp.clip(dot(-unit_dir, normal), -1.0, 1.0)
    fr, cos_t = fresnel_dielectric_exact(cos_o, eta_i, eta_t)

    state, xi = rng_ops.rand_uniform(state)
    choose_reflect = xi < fr

    refl_dir = reflect(unit_dir, normal)
    refr_dir = refract(unit_dir, normal, relative_eta[..., None])
    refr_len2 = dot(refr_dir, refr_dir)
    refr_failed = refr_len2 <= 0.0
    refr_unit = refr_dir / jnp.sqrt(jnp.maximum(refr_len2, 1e-38))[..., None]

    eta_scale = (eta_t * eta_t) / (eta_i * eta_i)
    dir_scale = eta_scale * (jnp.abs(cos_t) / jnp.maximum(jnp.abs(cos_o), 1e-6))
    refr_weight = jnp.maximum(1.0 - fr, 0.0) * dir_scale

    reflecting = jnp.logical_or(choose_reflect, refr_failed)
    direction = where3(reflecting, refl_dir, refr_unit)
    weight = jnp.where(reflecting[..., None],
                       jnp.broadcast_to(fr[..., None], shape + (3,)),
                       jnp.broadcast_to(refr_weight[..., None], shape + (3,)))
    medium_event = jnp.where(
        jnp.logical_and(~reflecting, ~is_thin),
        jnp.where(front_face, 1, -1), 0).astype(jnp.int32)

    out = BsdfSample.invalid(shape)
    out = out.replace(
        direction=safe_normalize(direction),
        weight=weight,
        pdf=jnp.ones(shape, jnp.float32),
        directional_pdf=jnp.ones(shape, jnp.float32),
        is_delta=jnp.ones(shape, bool),
        medium_event=medium_event,
        lobe_type=jnp.ones(shape, jnp.int32),
        lobe_roughness=jnp.zeros(shape, jnp.float32))
    return state, out


def _sample_plastic(m, normal, wo, state, clamp_p, diffuse_occlusion, specular_only):
    """case 4 (reference: pathtrace.metal:5285-5419).

    Draws 1 selector + 2 lobe uniforms per lane (both lobes draw exactly 2).
    """
    shape = normal.shape[:-1]
    cos_o = dot(normal, wo)
    coat_roughness = plastic_coat_roughness(m)
    alpha = coat_roughness * coat_roughness
    f0 = plastic_coat_f0(m)
    f0c = f0[..., None] * jnp.ones((1,) * len(shape) + (3,), jnp.float32)
    p_coat = jnp.clip(m.coat_sample_weight, 0.0, 1.0)
    p_coat = jnp.where(specular_only, 1.0, p_coat)
    p_diffuse = 1.0 - p_coat
    fresnel_avg = jnp.clip(m.coat_fresnel_avg, 0.0, 1.0)
    spec_tint = plastic_specular_tint(m)

    state, selector = rng_ops.rand_uniform(state)
    sample_coat = jnp.logical_and(selector < p_coat, p_coat > 0.0)

    # --- coat branch (2 draws via VNDF)
    state_c, wh = sample_ggx_vndf(normal, wo, coat_roughness, state)
    wi_c = safe_normalize(reflect(-wo, wh))
    cos_i_c = dot(normal, wi_c)
    dot_wi_wh = dot(wi_c, wh)
    d = ggx_d(alpha, normal, wh)
    g = ggx_g1(alpha, cos_o) * ggx_g1(alpha, cos_i_c)
    f = schlick_fresnel(f0c, dot_wi_wh)
    spec = f * (d * g / jnp.maximum(4.0 * cos_o * cos_i_c, 1e-6))[..., None]
    spec = clamp_specular_tail(spec, coat_roughness, f0c, clamp_p)
    spec = spec * spec_tint
    spec_pdf_raw = ggx_pdf(alpha, normal, wo, wi_c)
    spec_pdf = jnp.where(spec_pdf_raw > 0.0,
                         clamp_specular_pdf(spec_pdf_raw, clamp_p), 0.0)
    diff_pdf_c = lambert_pdf(normal, wi_c)
    combined_pdf_c = p_coat * spec_pdf + p_diffuse * diff_pdf_c
    weight_c = spec * (cos_i_c / jnp.maximum(combined_pdf_c, 1e-20))[..., None]
    coat_ok = ((dot(wh, normal) > 0.0) & (cos_i_c > 0.0) & (dot_wi_wh > 0.0)
               & (combined_pdf_c > 0.0) & jnp.all(jnp.isfinite(weight_c), -1))

    # --- diffuse branch (2 draws via cosine hemisphere)
    state_d, local = rng_ops.sample_cosine_hemisphere(state)
    wi_d = safe_normalize(to_world(local, normal))
    cos_i_d = dot(normal, wi_d)
    base = material_base_color(m)
    diffuse = base / PI
    diffuse = diffuse * jnp.clip(diffuse_occlusion, 0.0, 1.0)[..., None]
    tint_through = plastic_diffuse_transmission(m, cos_i_d, cos_o)
    f_i = schlick_fresnel(f0c, cos_i_d)
    f_o = schlick_fresnel(f0c, cos_o)
    diffuse = diffuse * tint_through * (1.0 - f_i) * (1.0 - f_o)
    diffuse = diffuse * jnp.maximum(1.0 - fresnel_avg, 0.0)[..., None]
    diffuse = jnp.maximum(diffuse, 0.0)
    diffuse = jnp.where(specular_only, 0.0, diffuse)
    diff_pdf_d = lambert_pdf(normal, wi_d)
    spec_pdf_raw_d = ggx_pdf(alpha, normal, wo, wi_d)
    spec_pdf_d = jnp.where(spec_pdf_raw_d > 0.0,
                           clamp_specular_pdf(spec_pdf_raw_d, clamp_p), 0.0)
    combined_pdf_d = p_coat * spec_pdf_d + p_diffuse * diff_pdf_d
    weight_d = diffuse * (cos_i_d / jnp.maximum(combined_pdf_d, 1e-20))[..., None]
    diff_ok = ((cos_i_d > 0.0) & (combined_pdf_d > 0.0)
               & jnp.all(jnp.isfinite(weight_d), -1))

    out = BsdfSample.invalid(shape)
    coat_valid = sample_coat & coat_ok & (cos_o > 0.0)
    diff_valid = (~sample_coat) & diff_ok & (cos_o > 0.0)
    out = out.replace(
        direction=where3(coat_valid, wi_c,
                         where3(diff_valid, wi_d, out.direction)),
        weight=where3(coat_valid, jnp.maximum(weight_c, 0.0),
                      where3(diff_valid, jnp.maximum(weight_d, 0.0), out.weight)),
        pdf=jnp.where(coat_valid, combined_pdf_c,
                      jnp.where(diff_valid, combined_pdf_d, 0.0)),
        directional_pdf=jnp.where(coat_valid, combined_pdf_c,
                                  jnp.where(diff_valid, combined_pdf_d, 0.0)),
        lobe_type=jnp.where(coat_valid, 1, 0),
        lobe_roughness=jnp.where(coat_valid, coat_roughness,
                                 jnp.where(diff_valid, 1.0, 0.0)))
    state = jnp.where(sample_coat, state_c, state_d)
    return state, out


def _sample_sss_fallback(m, normal, state):
    """case 5 lambert fallback, used when separable SSS is off/failed
    (reference: pathtrace.metal:5482-5508). Full separable/random-walk SSS
    lives in ops/sss.py (sample_bsdf handles mode selection)."""
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


# ---------------------------------------------------------------------------
# Dispatchers
# ---------------------------------------------------------------------------

def sample_bsdf(m: MatLanes, position, normal, wo, incident, front_face,
                state, clamp_p: ClampParams, sss_mode: int,
                diffuse_occlusion, specular_only: bool,
                material_types) -> tuple:
    """Type-dispatched BSDF sampling over the wavefront
    (reference: pathtrace.metal sample_bsdf:5136-5717).

    `material_types` is the static set of types present; only those branches
    are compiled. Returns (new_state, BsdfSample).
    """
    shape = normal.shape[:-1]
    out = BsdfSample.invalid(shape)
    new_state = state

    types = set(int(t) for t in material_types)

    def merge(type_id, branch_state, branch_out):
        nonlocal out, new_state
        mask = m.mat_type == type_id
        out = _select_sample(mask, branch_out, out)
        new_state = jnp.where(mask, branch_state, new_state)

    if C.MATERIAL_LAMBERTIAN in types:
        s, o = _sample_lambert(m, normal, state, diffuse_occlusion)
        if specular_only:
            o = BsdfSample.invalid(shape)
            s = state
        merge(C.MATERIAL_LAMBERTIAN, s, o)
    if C.MATERIAL_METAL in types:
        s, o = _sample_metal(m, normal, wo, incident, state, clamp_p)
        merge(C.MATERIAL_METAL, s, o)
    if C.MATERIAL_DIELECTRIC in types:
        s, o = _sample_dielectric(m, normal, incident, front_face, state)
        merge(C.MATERIAL_DIELECTRIC, s, o)
    # DiffuseLight (3): the integrator terminates on light hits before
    # sampling, so no branch is needed; lanes keep the invalid sample.
    if C.MATERIAL_PLASTIC in types:
        s, o = _sample_plastic(m, normal, wo, state, clamp_p,
                               diffuse_occlusion, specular_only)
        merge(C.MATERIAL_PLASTIC, s, o)
    if C.MATERIAL_SUBSURFACE in types:
        from metal_pathtracer.ops import sss as sss_ops
        s, o = sss_ops.sample_subsurface(m, position, normal, wo, state,
                                         clamp_p, sss_mode, specular_only)
        merge(C.MATERIAL_SUBSURFACE, s, o)
    if C.MATERIAL_CARPAINT in types:
        from metal_pathtracer.ops import carpaint as carpaint_ops
        s, o = carpaint_ops.sample_carpaint(m, position, normal, wo, state,
                                            clamp_p, specular_only)
        merge(C.MATERIAL_CARPAINT, s, o)
    if C.MATERIAL_PBR in types:
        from metal_pathtracer.ops import pbr as pbr_ops
        s, o = pbr_ops.sample_pbr(m, normal, wo, incident, state, clamp_p,
                                  diffuse_occlusion, specular_only)
        merge(C.MATERIAL_PBR, s, o)

    return new_state, out


def evaluate_bsdf(m: MatLanes, position, normal, wo, wi,
                  clamp_p: ClampParams, sss_mode: int, diffuse_occlusion,
                  specular_only: bool, material_types) -> BsdfEval:
    """Type-dispatched BSDF evaluation (no RNG)
    (reference: pathtrace.metal evaluate_bsdf:4950-5136)."""
    shape = normal.shape[:-1]
    cos_o = jnp.maximum(dot(normal, wo), 0.0)
    cos_i = jnp.maximum(dot(normal, wi), 0.0)
    geom_ok = (cos_i > 0.0) & (cos_o > 0.0)

    value = jnp.zeros(shape + (3,), jnp.float32)
    pdf = jnp.zeros(shape, jnp.float32)
    is_delta = jnp.zeros(shape, bool)
    is_bssrdf = jnp.zeros(shape, bool)

    types = set(int(t) for t in material_types)

    if C.MATERIAL_LAMBERTIAN in types and not specular_only:
        mask = (m.mat_type == C.MATERIAL_LAMBERTIAN) & geom_ok
        albedo = material_base_color(m) * jnp.clip(diffuse_occlusion, 0.0, 1.0)[..., None]
        v = albedo / PI
        p = lambert_pdf(normal, wi)
        value = where3(mask, v, value)
        pdf = jnp.where(mask, p, pdf)

    if C.MATERIAL_METAL in types:
        rough = jnp.clip(m.roughness, 0.0, 1.0)
        smooth = rough <= 1e-3
        mask = (m.mat_type == C.MATERIAL_METAL) & geom_ok
        is_delta = jnp.where(mask & smooth, True, is_delta)
        alpha = rough * rough
        wh = safe_normalize(wo + wi)
        half_ok = (dot(wh, normal) > 0.0) & (dot(wo, wh) > 0.0) & (dot(wi, wh) > 0.0)
        d = ggx_d(alpha, normal, wh)
        g = ggx_g1(alpha, cos_o) * ggx_g1(alpha, cos_i)
        f0 = conductor_f0(m)
        f = where3(material_has_conductor_ior(m),
                   fresnel_conductor(dot(wi, wh), m.conductor_eta, m.conductor_k),
                   schlick_fresnel(f0, dot(wi, wh)))
        spec = f * (d * g / jnp.maximum(4.0 * cos_o * cos_i, 1e-6))[..., None]
        spec = spec * specular_energy_compensation(f0, rough, cos_o)
        spec = clamp_specular_tail(spec, rough, f0, clamp_p)
        p_raw = ggx_pdf(alpha, normal, wo, wi)
        p_c = clamp_specular_pdf(p_raw, clamp_p)
        valid = mask & (~smooth) & half_ok & (p_raw > 0.0)
        value = where3(valid, jnp.maximum(spec, 0.0), value)
        pdf = jnp.where(valid, p_c, pdf)

    if C.MATERIAL_DIELECTRIC in types:
        is_delta = jnp.where(m.mat_type == C.MATERIAL_DIELECTRIC, True, is_delta)

    if C.MATERIAL_PLASTIC in types:
        mask = (m.mat_type == C.MATERIAL_PLASTIC) & geom_ok
        coat_roughness = plastic_coat_roughness(m)
        alpha = coat_roughness * coat_roughness
        f0 = plastic_coat_f0(m)
        f0c = f0[..., None] * jnp.ones((1,) * len(shape) + (3,), jnp.float32)
        wh = safe_normalize(wo + wi)
        half_ok = (dot(wh, normal) > 0.0) & (dot(wo, wh) > 0.0) & (dot(wi, wh) > 0.0)
        d = ggx_d(alpha, normal, wh)
        g = ggx_g1(alpha, cos_o) * ggx_g1(alpha, cos_i)
        f = schlick_fresnel(f0c, dot(wi, wh))
        spec = f * (d * g / jnp.maximum(4.0 * cos_o * cos_i, 1e-6))[..., None]
        spec = clamp_specular_tail(spec, coat_roughness, f0c, clamp_p)
        spec = spec * plastic_specular_tint(m)
        spec = jnp.where(half_ok[..., None], jnp.maximum(spec, 0.0), 0.0)
        spec_pdf_raw = ggx_pdf(alpha, normal, wo, wi)
        spec_pdf = jnp.where(half_ok & (spec_pdf_raw > 0.0),
                             clamp_specular_pdf(spec_pdf_raw, clamp_p), 0.0)

        f_i = schlick_fresnel(f0c, cos_i)
        f_o = schlick_fresnel(f0c, cos_o)
        tint = plastic_diffuse_transmission(m, cos_i, cos_o)
        diffuse = material_base_color(m) / PI
        diffuse = diffuse * jnp.clip(diffuse_occlusion, 0.0, 1.0)[..., None]
        diffuse = diffuse * tint * (1.0 - f_i) * (1.0 - f_o)
        diffuse = diffuse * jnp.maximum(
            1.0 - jnp.clip(m.coat_fresnel_avg, 0.0, 1.0), 0.0)[..., None]
        diffuse = jnp.maximum(diffuse, 0.0)
        if specular_only:
            diffuse = jnp.zeros_like(diffuse)
        diff_pdf = lambert_pdf(normal, wi)
        p_coat = jnp.clip(m.coat_sample_weight, 0.0, 1.0)
        p_diffuse = 1.0 - p_coat
        if specular_only:
            p_coat = jnp.ones_like(p_coat)
            p_diffuse = jnp.zeros_like(p_diffuse)
        value = where3(mask, spec + diffuse, value)
        pdf = jnp.where(mask, p_coat * spec_pdf + p_diffuse * diff_pdf, pdf)

    if C.MATERIAL_SUBSURFACE in types:
        is_bssrdf = jnp.where(m.mat_type == C.MATERIAL_SUBSURFACE, True, is_bssrdf)

    if C.MATERIAL_CARPAINT in types:
        from metal_pathtracer.ops import carpaint as carpaint_ops
        mask = (m.mat_type == C.MATERIAL_CARPAINT) & geom_ok
        v, p = carpaint_ops.evaluate_carpaint(m, position, normal, wo, wi, clamp_p)
        value = where3(mask, v, value)
        pdf = jnp.where(mask, p, pdf)

    if C.MATERIAL_PBR in types:
        from metal_pathtracer.ops import pbr as pbr_ops
        mask = (m.mat_type == C.MATERIAL_PBR) & geom_ok
        ev = pbr_ops.evaluate_pbr(m, normal, wo, wi, clamp_p,
                                  diffuse_occlusion, specular_only)
        value = where3(mask, ev.value, value)
        pdf = jnp.where(mask, ev.pdf, pdf)
        is_delta = jnp.where(mask, ev.is_delta, is_delta)

    bad = (pdf <= 0.0) | ~jnp.all(jnp.isfinite(value), -1)
    value = where3(bad, jnp.zeros_like(value), value)
    return BsdfEval(value=value, pdf=pdf, directional_pdf=pdf,
                    is_delta=is_delta, is_bssrdf=is_bssrdf)


def bsdf_cone_spread_increment(lobe_type, roughness, is_delta):
    """(reference: pathtrace.metal bsdf_cone_spread_increment)"""
    r = jnp.clip(roughness, 0.0, 1.0)
    inc = jnp.where(lobe_type == 0, 0.55,
                    jnp.where(lobe_type == 1, 0.03 + (0.45 - 0.03) * r,
                              0.10 + (0.60 - 0.10) * r))
    return jnp.where(is_delta, 0.0, inc)
