"""Single source of truth for device-side data layouts.

The reference keeps byte-identical twin structs in C++ and MSL by hand
(reference: include/MetalShaderTypes.h vs shaders/common.metal). Here every
GPU-side struct becomes ONE struct-of-arrays pytree defined in this module;
the Python dataclass is the schema and the (optional) C++ header for the
native CPU oracle is generated from it (native/gen_header.py).

All arrays are float32/int32/uint32 with static shapes — the shapes are part
of the jit cache key, so a given scene compiles once.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from metal_pathtracer.utils import pytree


Array = Any


@pytree.dataclass
class MaterialsSoA:
    """Struct-of-arrays twin of the reference's MaterialData AoS
    (reference: include/MetalShaderTypes.h:57-97). One row per material.
    """

    base_color: Array          # (M,3) f32 — base color / F0 tint
    roughness: Array           # (M,)  f32
    mat_type: Array            # (M,)  i32 — MaterialType enum
    eta: Array                 # (M,)  f32 — base IOR
    coat_ior: Array            # (M,)  f32
    thin: Array                # (M,)  f32 — thin dielectric flag
    emission: Array            # (M,3) f32
    emission_env: Array        # (M,)  f32 — env-sampled emission flag
    conductor_eta: Array       # (M,3) f32
    conductor_k: Array         # (M,3) f32
    has_conductor: Array       # (M,)  f32 — >0 when eta/k valid
    coat_roughness: Array      # (M,)  f32
    coat_thickness: Array      # (M,)  f32
    coat_sample_weight: Array  # (M,)  f32 — derived (SceneResources.mm ComputeCoatSampleWeight)
    coat_fresnel_avg: Array    # (M,)  f32 — derived (ComputeCoatAverage)
    coat_tint: Array           # (M,3) f32
    coat_absorption: Array     # (M,3) f32
    dielectric_sigma_a: Array  # (M,3) f32 — glass absorption per meter
    sss_sigma_a: Array         # (M,3) f32
    sss_sigma_override: Array  # (M,)  f32 — 1 = explicit sigma_a/sigma_s
    sss_sigma_s: Array         # (M,3) f32
    sss_g: Array               # (M,)  f32 — HG anisotropy
    sss_mfp: Array             # (M,)  f32 — mean free path
    sss_method: Array          # (M,)  f32 — 0=separable 1=randomwalk
    sss_coat: Array            # (M,)  f32 — coat enabled flag
    carpaint_base_metallic: Array         # (M,) f32
    carpaint_base_roughness: Array        # (M,) f32
    carpaint_flake_scale: Array           # (M,) f32
    carpaint_flake_reflectance: Array     # (M,) f32
    carpaint_flake_sample_weight: Array   # (M,) f32
    carpaint_flake_roughness: Array       # (M,) f32
    carpaint_flake_anisotropy: Array      # (M,) f32
    carpaint_flake_normal_strength: Array  # (M,) f32
    carpaint_base_eta: Array   # (M,3) f32
    carpaint_base_k: Array     # (M,3) f32
    carpaint_has_base_conductor: Array  # (M,) f32
    carpaint_base_tint: Array  # (M,3) f32
    # PBR metallic-roughness (glTF) parameters
    pbr_metallic: Array        # (M,)  f32
    pbr_roughness: Array       # (M,)  f32
    pbr_occlusion_strength: Array  # (M,) f32
    pbr_normal_scale: Array    # (M,)  f32
    pbr_alpha: Array           # (M,)  f32 — alpha factor
    pbr_alpha_cutoff: Array    # (M,)  f32
    pbr_transmission: Array    # (M,)  f32
    pbr_alpha_mode: Array      # (M,)  f32 — 0=opaque 1=mask 2=blend
    pbr_double_sided: Array    # (M,)  f32
    pbr_thickness: Array       # (M,)  f32 — volume thickness
    texture_indices: Array     # (M,6) i32 — base/mr/normal/occlusion/emissive/transmission (-1 = none)
    texture_uv_set: Array      # (M,6) i32
    texture_transform: Array   # (M,6,2,3) f32 — KHR_texture_transform 2x3 per slot
    material_flags: Array      # (M,)  i32 — bitfield

    @property
    def count(self) -> int:
        return self.mat_type.shape[0]


@pytree.dataclass
class SpheresSoA:
    """(reference: MetalShaderTypes.h SphereData)"""

    center: Array    # (S,3) f32
    radius: Array    # (S,)  f32
    material: Array  # (S,)  i32

    @property
    def count(self) -> int:
        return self.radius.shape[0]


@pytree.dataclass
class RectsSoA:
    """Oriented rectangles (reference: MetalShaderTypes.h RectData)."""

    corner: Array      # (R,3) f32
    edge_u: Array      # (R,3) f32
    edge_v: Array      # (R,3) f32
    inv_len2_u: Array  # (R,)  f32
    inv_len2_v: Array  # (R,)  f32
    normal: Array      # (R,3) f32 — normalized
    plane: Array       # (R,)  f32 — dot(normal, corner)
    material: Array    # (R,)  i32
    two_sided: Array   # (R,)  f32

    @property
    def count(self) -> int:
        return self.plane.shape[0]


@pytree.dataclass
class BvhSoA:
    """Flattened BVH in depth-first order with skip links, built natively.

    A redesign of the reference's 2-wide child-pointer nodes
    (reference: MetalShaderTypes.h BvhNode, BvhBuilder.mm:26-166) into a
    stackless layout suited to a vectorized / Pallas traversal: each node
    carries `exit` (where to jump on a miss) so traversal is a single loop
    with no per-lane stack.
    """

    bounds_min: Array  # (N,3) f32
    bounds_max: Array  # (N,3) f32
    prim_offset: Array  # (N,) i32 — first primitive when leaf
    prim_count: Array   # (N,) i32 — 0 for internal nodes
    exit_index: Array   # (N,) i32 — node index to jump to on miss/after leaf
    prim_indices: Array  # (P,) i32 — reordered primitive ids

    @property
    def node_count(self) -> int:
        return self.prim_offset.shape[0]


@pytree.dataclass
class TraversalTables:
    """The BVH re-packed for the traversal kernel (ops/pallas/traverse.py).

    Its presence on a scene selects the kernel route; the fields below the
    arrays are static, so they are part of the jit cache key."""

    node_rows: Array  # (N, 8) i32 — bounds (f32 bits), exit, leaf word
    tri_rows: Array   # (P, 12) i32 — leaf-order v0 v1 v2 (f32 bits), id, mesh
    block: int = pytree.static_field(default=128)  # lanes per program;
    # one lane per thread, so block // 32 warps
    interpret: bool = pytree.static_field(default=False)


@pytree.dataclass
class TrianglesSoA:
    """World-space triangle soup + per-vertex shading attributes."""

    v0: Array       # (T,3) f32
    v1: Array       # (T,3) f32
    v2: Array       # (T,3) f32
    material: Array  # (T,) i32
    mesh_index: Array  # (T,) i32
    # Per-corner shading attributes (already de-indexed to triangle corners)
    n0: Array       # (T,3) f32 shading normals
    n1: Array
    n2: Array
    uv0: Array      # (T,2) f32 texture coords, UV set 0
    uv1: Array
    uv2: Array
    uvb0: Array     # (T,2) f32 texture coords, UV set 1
    uvb1: Array
    uvb2: Array
    t0: Array       # (T,4) f32 tangent (xyz) + handedness (w)
    t1: Array
    t2: Array
    # Hot-path attribute pack: [v0(3) v1(3) v2(3) n0(3) n1(3) n2(3)
    # material mesh_index pad pad] — ONE row gather per wave instead of 8
    # narrow ones.
    shade_packed: Array = None  # (T, 24) f32

    @property
    def count(self) -> int:
        return self.material.shape[0]


@pytree.dataclass
class EnvironmentSoA:
    """Equirect environment map + alias tables for importance sampling
    (reference: src/renderer/EnvImportanceSampler.mm:16-236).
    """

    texels: Array            # (mip0: H,W,3) f32 linear radiance
    mips: Any                # tuple of (Hi,Wi,3) arrays, coarse mip chain
    marginal_threshold: Array    # (H,)  f32 — Vose alias threshold per row
    marginal_alias: Array        # (H,)  i32
    conditional_threshold: Array  # (H,W) f32
    conditional_alias: Array      # (H,W) i32
    pdf: Array               # (H,W) f32 — per-texel solid-angle pdf
    width: int = pytree.static_field(default=0)
    height: int = pytree.static_field(default=0)
    # Flat mip atlas: all levels (mip0 first) concatenated row-major into
    # one (total_texels, 3) array, so a trilinear lookup gathers only its
    # two adjacent levels (8 texel rows) instead of bilinear-sampling every
    # level and one-hot-selecting (44+ gathers at 11 levels). mip_meta is
    # the static ((offset, h, w), ...) per level.
    flat_mips: Array = None
    mip_meta: Any = pytree.static_field(default=())
    # Gather-packed variants: a row gather of K contiguous elements in
    # place of K narrow gathers (env NEE issues many). Values are
    # bit-identical copies of the tables above:
    #   flat_quads[off + y0*w + x0] = [c00, c10, c01, c11] (12) — a whole
    #     bilinear footprint (wrap-x/y neighbours) in ONE row gather;
    #   cond_packed[row, col] = [conditional_threshold, conditional_alias,
    #     pdf] — the alias step's three per-texel reads in one;
    #   marg_packed[row] = [marginal_threshold, marginal_alias].
    # Alias indices ride as f32 (exact: dims < 2^24). None => the unpacked
    # fallback paths (hand-built EnvironmentSoA) are used.
    flat_quads: Array = None
    cond_packed: Array = None
    marg_packed: Array = None
    # NEE texel radiance rows: nee_packed[row, col] = [pdf, R, G, B] with
    # RGB the mip0 texel radiance the pdf was BUILT from. Env NEE fetches
    # its radiance from the sampled texel itself (one 4-wide row gather)
    # instead of re-projecting the jittered direction through
    # atan2/asin and a bilinear(+roughness-LOD) atlas lookup — radiance
    # and pdf become exactly consistent (L/pdf is constant in luminance,
    # strictly lower variance than the reference's jittered fetch,
    # pathtrace.metal:1543-1573) at the cost of treating the env map as
    # piecewise-constant for NEE. Documented deviation; the CPU oracle
    # (native/cpu_oracle.cpp env_sample) implements the same estimator.
    nee_packed: Array = None


@pytree.dataclass
class SceneArrays:
    """Everything the integrator needs on device, as one pytree.

    Replaces the reference's ~20 bound Metal buffers
    (reference: src/renderer/RenderLoop.mm:256-364).
    """

    spheres: SpheresSoA
    rects: RectsSoA
    materials: MaterialsSoA
    triangles: Optional[TrianglesSoA] = None
    tri_bvh: Optional[BvhSoA] = None        # BLAS over all world-space triangles
    # Rows for the traversal kernel; None selects the XLA traversal route
    tri_kernel: Optional[TraversalTables] = None
    environment: Optional[EnvironmentSoA] = None
    # Rect lights for NEE: indices of emissive rectangles, static shape.
    light_rect_indices: Array = None  # (L,) i32
    textures: Any = None  # texture atlas pytree (ops/textures.py), or None
    # Instanced mesh groups (shared BLAS per source; see InstanceGroup).
    # A tuple so the pytree structure is static per scene.
    instanced: Any = ()


@pytree.dataclass
class CameraUniforms:
    """RTOW-style orbit camera basis (reference: UniformBuilder.mm:34-83)."""

    origin: Array        # (3,)
    lower_left: Array    # (3,)
    horizontal: Array    # (3,)
    vertical: Array      # (3,)
    u: Array             # (3,)
    v: Array             # (3,)
    lens_radius: Array   # ()


@pytree.dataclass
class Uniforms:
    """Traced per-dispatch parameters (reference: MetalShaderTypes.h
    PathtraceUniforms:117-213). Flags that change compiled control flow live
    in StaticConfig instead.
    """

    camera: CameraUniforms
    frame_index: Array        # () u32
    sample_count: Array       # () u32 — accumulated samples before this dispatch
    fixed_rng_seed: Array     # () u32
    background_color: Array   # (3,) f32
    environment_rotation: Array   # () f32
    environment_intensity: Array  # () f32
    # Firefly clamping (reference: pathtrace.metal make_firefly_params)
    firefly_clamp_enabled: Array  # () f32
    firefly_clamp_factor: Array   # () f32
    firefly_clamp_floor: Array    # () f32
    throughput_clamp: Array       # () f32
    specular_tail_clamp_base: Array           # () f32
    specular_tail_clamp_roughness_scale: Array  # () f32
    min_specular_pdf: Array       # () f32
    firefly_clamp_max_contribution: Array  # () f32
    debug_normal_strength_scale: Array = None  # () f32
    debug_normal_lod_bias: Array = None        # () f32
    debug_orm_lod_bias: Array = None           # () f32
    debug_env_mip_override: Array = None       # () f32


@pytree.dataclass
class StaticConfig:
    """Hashable jit-static render configuration.

    The reference runtime-compiles MSL with preprocessor macros and branches
    on uniform flags (reference: src/renderer/Pipelines.mm:128-160); here the
    same toggles select jit specializations.
    """

    width: int
    height: int
    max_depth: int
    use_russian_roulette: bool
    background_mode: int            # 0 gradient / 1 solid / 2 environment
    working_color_space: int        # 0 linear sRGB / 1 ACEScg
    sss_mode: int
    sss_max_steps: int
    enable_specular_nee: bool
    enable_mnee: bool
    enable_mnee_secondary: bool
    debug_view_mode: int = 0
    debug_specular_only: bool = False
    debug_disable_ao: bool = False
    debug_ao_indirect_only: bool = True
    debug_disable_normal_map: bool = False
    debug_disable_orm: bool = False
    debug_flip_normal_green: bool = False
    debug_env_nearest: bool = False
    # Material types present in the scene — lets the integrator skip BSDF
    # branches for absent types (the analogue of shader specialization).
    material_types: Tuple[int, ...] = ()
    # Texture slots (base/ORM/normal/occlusion/emissive/transmission) bound
    # by at least one material — absent slots compile to their defaults
    # with zero gathers (the reference binds a 1x1 white fallback and still
    # samples; here each slot is 8 texel gathers, worth specializing).
    texture_slots: Tuple[int, ...] = (0, 1, 2, 3, 4, 5)
    # Any material addressing UV set 1 — when false the UV1 interpolation
    # and its gradient plumbing compile out (most scenes are single-UV).
    texture_uv1: bool = True


def settings_to_static(settings, width: int, height: int, material_types,
                       texture_slots=None, texture_uv1=None) -> StaticConfig:
    return StaticConfig(
        texture_slots=(tuple(sorted(set(int(s) for s in texture_slots)))
                       if texture_slots is not None else (0, 1, 2, 3, 4, 5)),
        texture_uv1=bool(texture_uv1) if texture_uv1 is not None else True,
        width=int(width),
        height=int(height),
        max_depth=int(settings.maxDepth),
        use_russian_roulette=bool(settings.enableRussianRoulette),
        background_mode=int(settings.backgroundMode),
        working_color_space=int(settings.workingColorSpace),
        sss_mode=int(settings.sssMode),
        sss_max_steps=int(settings.sssMaxSteps),
        enable_specular_nee=bool(settings.enableSpecularNee),
        enable_mnee=bool(settings.enableMnee),
        enable_mnee_secondary=bool(settings.enableMneeSecondary),
        debug_specular_only=bool(settings.debugSpecularOnly),
        debug_disable_ao=bool(settings.debugDisableAO),
        debug_ao_indirect_only=bool(settings.debugAoIndirectOnly),
        debug_disable_normal_map=bool(settings.debugDisableNormalMap),
        debug_disable_orm=bool(settings.debugDisableOrmTexture),
        debug_flip_normal_green=bool(settings.debugFlipNormalGreen),
        debug_env_nearest=bool(settings.debugEnvNearest),
        debug_view_mode=(1 if settings.debugShowBaseColor else
                         2 if settings.debugShowMetallic else
                         3 if settings.debugShowRoughness else
                         4 if settings.debugShowAO else 0),
        material_types=tuple(sorted(set(int(t) for t in material_types))),
    )


def settings_to_uniforms(settings, camera: CameraUniforms, frame_index: int,
                         sample_count: int) -> Uniforms:
    f32 = jnp.float32
    u32 = jnp.uint32
    return Uniforms(
        camera=camera,
        frame_index=u32(frame_index),
        sample_count=u32(sample_count),
        fixed_rng_seed=u32(settings.fixedRngSeed),
        background_color=jnp.asarray(settings.backgroundColor, jnp.float32),
        environment_rotation=f32(settings.environmentRotation),
        environment_intensity=f32(settings.environmentIntensity),
        firefly_clamp_enabled=f32(1.0 if settings.fireflyClampEnabled else 0.0),
        firefly_clamp_factor=f32(max(settings.fireflyClampFactor, 0.0)),
        firefly_clamp_floor=f32(max(settings.fireflyClampFloor, 0.0)),
        throughput_clamp=f32(max(settings.throughputClamp, 0.0)),
        specular_tail_clamp_base=f32(max(settings.specularTailClampBase, 0.0)),
        specular_tail_clamp_roughness_scale=f32(
            max(settings.specularTailClampRoughnessScale, 0.0)),
        min_specular_pdf=f32(max(settings.minSpecularPdf, 0.0)),
        firefly_clamp_max_contribution=f32(
            max(settings.fireflyClampMaxContribution, 0.0)),
        debug_normal_strength_scale=f32(settings.debugNormalStrengthScale),
        debug_normal_lod_bias=f32(settings.debugNormalLodBias),
        debug_orm_lod_bias=f32(settings.debugOrmLodBias),
        debug_env_mip_override=f32(settings.debugEnvMipOverride),
    )


@pytree.dataclass
class InstanceGroup:
    """One shared object-space BLAS + its instance transforms.

    The reference keeps per-mesh BLAS + a TLAS of SoftwareInstanceInfo with
    localToWorld/worldToLocal (reference: src/renderer/SceneAccel.mm
    :173-247); here each group is traced per instance with the ray mapped
    into object space (t is transform-invariant for a linearly-mapped
    unnormalized direction), so N instances share ONE triangle store.
    """

    triangles: TrianglesSoA        # OBJECT-space soup of the source mesh
    tri_bvh: BvhSoA
    tri_kernel: Optional[TraversalTables]  # None: XLA traversal route
    l2w: Array                     # (I, 3, 4) local -> world affine rows
    w2l: Array                     # (I, 3, 4) world -> local affine rows
    nrm_mat: Array                 # (I, 3, 3) inverse-transpose linear part
    material: Array                # (I,) i32 per-instance material
    base_id: int = pytree.static_field(default=0)
    count: int = pytree.static_field(default=0)
