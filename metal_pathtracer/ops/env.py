"""Environment lighting: HDR load, mip chain, alias-table importance
sampling, equirect lookup.

Host-side construction ports the reference's CPU sampler exactly
(reference: src/renderer/EnvImportanceSampler.mm:16-236 — luminance x
solid-angle weights, Vose alias tables for the marginal row distribution
and per-row conditionals, per-texel solid-angle pdf). Device-side lookup
and sampling mirror the shader functions
(reference: shaders/pathtrace.metal:1326-1579) — all gathers.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

from metal_pathtracer.constants import LUMINANCE_WEIGHTS
from metal_pathtracer.ops import rng as rng_ops
from metal_pathtracer.schema import EnvironmentSoA

PI = np.pi
_UCLAMP = 0.99999994


# ---------------------------------------------------------------------------
# HDR image loading
# ---------------------------------------------------------------------------

def _load_radiance_hdr(path: str) -> np.ndarray:
    """Radiance RGBE (.hdr) decoder -> (H,W,3) float32 linear."""
    with open(path, "rb") as f:
        data = f.read()
    if not (data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE")):
        raise ValueError(f"not a Radiance HDR file: {path}")
    pos = data.index(b"\n\n") + 2
    dim_end = data.index(b"\n", pos)
    dims = data[pos:dim_end].decode("ascii").split()
    if dims[0] != "-Y" or dims[2] != "+X":
        raise ValueError(f"unsupported HDR orientation: {' '.join(dims)}")
    height, width = int(dims[1]), int(dims[3])
    pos = dim_end + 1

    rgbe = np.zeros((height, width, 4), np.uint8)
    buf = memoryview(data)
    for y in range(height):
        if pos + 4 <= len(data) and buf[pos] == 2 and buf[pos + 1] == 2 \
                and ((buf[pos + 2] << 8) | buf[pos + 3]) == width:
            # new-style RLE scanline
            pos += 4
            for c in range(4):
                x = 0
                while x < width:
                    count = buf[pos]
                    pos += 1
                    if count > 128:
                        run = count - 128
                        rgbe[y, x:x + run, c] = buf[pos]
                        pos += 1
                        x += run
                    else:
                        rgbe[y, x:x + count, c] = np.frombuffer(
                            buf[pos:pos + count], np.uint8)
                        pos += count
                        x += count
        else:
            # flat scanline
            row = np.frombuffer(buf[pos:pos + width * 4], np.uint8)
            rgbe[y] = row.reshape(width, 4)
            pos += width * 4

    mantissa = rgbe[..., :3].astype(np.float32)
    exponent = rgbe[..., 3].astype(np.int32)
    scale = np.where(exponent > 0,
                     np.ldexp(1.0, exponent - 136).astype(np.float32), 0.0)
    return mantissa * scale[..., None]


def load_hdr_image(path: str) -> np.ndarray:
    """(H,W,3) float32 linear radiance from .hdr/.exr/.pfm (+ LDR via png)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".hdr":
        return _load_radiance_hdr(path)
    if ext == ".pfm":
        from metal_pathtracer.utils.image_io import read_pfm
        img = read_pfm(path)
        return img if img.shape[-1] == 3 else np.repeat(img, 3, -1)
    if ext == ".exr":
        try:
            from metal_pathtracer.utils.image_io import read_exr
            ch = read_exr(path)
            return np.stack([ch["R"], ch["G"], ch["B"]], -1)
        except Exception:
            pass
        try:
            import imageio.v3 as iio
            return np.asarray(iio.imread(path), np.float32)[..., :3]
        except ImportError as exc:
            raise ValueError(
                "reading a compressed EXR needs the imageio package: "
                f"{path}") from exc
    try:
        import imageio.v3 as iio
        img = np.asarray(iio.imread(path), np.float32)
        if img.dtype == np.uint8 or img.max() > 64.0:
            img = (img / 255.0) ** 2.2
        return img[..., :3]
    except ImportError as exc:
        raise ValueError("reading an HDR/PNG environment map needs the "
                         f"imageio package: {path}") from exc


def build_mips(texels: np.ndarray) -> List[np.ndarray]:
    """Box-filter mip chain down to 1x1 (the reference blits a full chain,
    SceneResources.mm:1490-1609)."""
    mips = []
    cur = texels
    while min(cur.shape[0], cur.shape[1]) > 1:
        h, w = cur.shape[:2]
        h2, w2 = max(h // 2, 1), max(w // 2, 1)
        trimmed = cur[:h2 * 2, :w2 * 2]
        cur = trimmed.reshape(h2, 2, w2, 2, 3).mean((1, 3)).astype(np.float32)
        mips.append(cur)
    return mips


# ---------------------------------------------------------------------------
# Alias tables (Vose) — numerical twin of BuildAliasTable
# ---------------------------------------------------------------------------

def build_alias_table(probabilities: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(reference: EnvImportanceSampler.mm BuildAliasTable:16-66)"""
    n = len(probabilities)
    alias = np.zeros(n, np.uint32)
    threshold = np.zeros(n, np.float32)
    if n == 0:
        return alias, threshold
    scaled = (probabilities.astype(np.float64) * n).astype(np.float32)
    small = [i for i in range(n) if scaled[i] < 1.0]
    large = [i for i in range(n) if scaled[i] >= 1.0]
    while small and large:
        s = small.pop()
        l = large[-1]
        threshold[s] = min(max(scaled[s], 0.0), 1.0)
        alias[s] = l
        scaled[l] = (scaled[l] + scaled[s]) - 1.0
        if scaled[l] < 1.0 - 1e-7:
            small.append(l)
            large.pop()
    for i in small + large:
        threshold[i] = 1.0
        alias[i] = i
    return alias, threshold


def build_distribution(texels: np.ndarray):
    """Luminance x solid-angle weights -> marginal/conditional alias tables
    + per-texel solid-angle pdf
    (reference: EnvImportanceSampler.mm BuildEnvImportanceDistribution:68-170)."""
    height, width = texels.shape[:2]
    d_theta = PI / height
    d_phi = (2.0 * PI) / width

    lum = texels @ np.asarray(LUMINANCE_WEIGHTS, np.float32)
    theta = (np.arange(height) + 0.5) * d_theta
    cell_solid = np.maximum(np.sin(theta), 0.0) * d_theta * d_phi  # (H,)
    weights = np.maximum(lum, 0.0) * cell_solid[:, None]
    row_weights = weights.sum(1)
    total = float(weights.sum())
    if total <= 0.0:
        raise ValueError("Environment map contains no positive radiance")

    marginal_prob = np.where(row_weights > 0.0, row_weights / total, 0.0)
    marginal_alias, marginal_threshold = build_alias_table(
        marginal_prob.astype(np.float32))

    cond_alias = np.zeros((height, width), np.uint32)
    cond_threshold = np.zeros((height, width), np.float32)
    for y in range(height):
        if row_weights[y] > 0.0:
            p = weights[y] / row_weights[y]
        else:
            p = np.full(width, 1.0 / width, np.float32)
        a, t = build_alias_table(p.astype(np.float32))
        cond_alias[y] = a
        cond_threshold[y] = t

    prob = weights / total
    pdf = np.where(cell_solid[:, None] > 0.0, prob / cell_solid[:, None], 0.0)
    return (marginal_alias, marginal_threshold, cond_alias, cond_threshold,
            pdf.astype(np.float32))


def load_environment(path: str, to_device: bool = True) -> EnvironmentSoA:
    return environment_from_texels(load_hdr_image(path), to_device)


def environment_from_texels(texels: np.ndarray,
                            to_device: bool = True) -> EnvironmentSoA:
    """Build the full EnvironmentSoA (mips + alias tables + pdf) from an
    in-memory (H,W,3) linear-radiance array — the load_environment core,
    split out for procedural environments (bench.py's HDR sky)."""
    if to_device:
        import jax.numpy as jnp
        f = jnp.asarray
    else:
        # pure-numpy consumers (CPU oracle) must not touch the device
        f = np.asarray

    texels = np.asarray(texels, np.float32)
    mips = build_mips(texels)
    (marg_alias, marg_thresh, cond_alias, cond_thresh, pdf) = \
        build_distribution(texels)
    # Flat mip atlas (schema.EnvironmentSoA.flat_mips): levels concatenated
    # so trilinear lookups gather from just the two adjacent levels.
    levels = [texels] + list(mips)
    meta = []
    off = 0
    for m in levels:
        meta.append((off, int(m.shape[0]), int(m.shape[1])))
        off += int(m.shape[0]) * int(m.shape[1])
    flat = np.concatenate([m.reshape(-1, 3) for m in levels], 0)

    # Quad atlas: every level's full bilinear footprint per texel
    # ([c00, c10, c01, c11], wrap addressing on both axes) so a lookup is
    # ONE 12-wide row gather instead of four 3-wide ones.
    def quads(m):
        right = np.roll(m, -1, axis=1)
        down = np.roll(m, -1, axis=0)
        down_right = np.roll(right, -1, axis=0)
        return np.concatenate([m, right, down, down_right],
                              -1).reshape(-1, 12)

    flat_quads = np.concatenate([quads(m) for m in levels], 0)
    cond_packed = np.stack([cond_thresh,
                            cond_alias.astype(np.float32), pdf], -1)
    marg_packed = np.stack([marg_thresh,
                            marg_alias.astype(np.float32)], -1)
    nee_packed = np.concatenate([pdf[..., None], texels], -1)
    return EnvironmentSoA(
        texels=f(texels),
        mips=tuple(f(m) for m in mips),
        marginal_threshold=f(marg_thresh),
        marginal_alias=f(marg_alias.astype(np.int32)),
        conditional_threshold=f(cond_thresh),
        conditional_alias=f(cond_alias.astype(np.int32)),
        pdf=f(pdf),
        width=int(texels.shape[1]),
        height=int(texels.shape[0]),
        flat_mips=f(flat),
        mip_meta=tuple(meta),
        flat_quads=f(flat_quads),
        cond_packed=f(cond_packed),
        marg_packed=f(marg_packed),
        nee_packed=f(nee_packed),
    )


# ---------------------------------------------------------------------------
# Device-side lookup (jnp)
# ---------------------------------------------------------------------------


def _use_packed(env) -> bool:
    """Packed-gather paths (quad atlas / packed alias rows). MPT_ENV_PACKED=0
    opts out for interleaved A/B timing (read at trace time)."""
    return (env.flat_quads is not None
            and os.environ.get("MPT_ENV_PACKED", "1") == "1")


def _use_texel_nee(env) -> bool:
    """Texel-exact NEE radiance (see schema nee_packed). MPT_ENV_TEXEL=0
    opts back into the reference's jittered bilinear+LOD fetch for
    interleaved A/B timing / RMSE budgeting (read at trace time). Works
    with or without the packed row (hand-built EnvironmentSoA falls back
    to a texels[row, col] gather) so JAX and the CPU oracle always
    implement the same estimator."""
    return os.environ.get("MPT_ENV_TEXEL", "1") == "1"


def _direction_to_uv(direction, rotation):
    """Equirect mapping with Y-axis rotation
    (reference: pathtrace.metal environment_color:1372-1386)."""
    import jax.numpy as jnp
    from metal_pathtracer.ops.vecmath import normalize

    unit = normalize(direction)
    cos_t = jnp.cos(rotation)
    sin_t = jnp.sin(rotation)
    rx = unit[..., 0] * cos_t - unit[..., 2] * sin_t
    ry = unit[..., 1]
    rz = unit[..., 0] * sin_t + unit[..., 2] * cos_t
    u = (jnp.arctan2(rz, rx) + PI) / (2.0 * PI)
    v = 0.5 - jnp.arcsin(jnp.clip(ry, -1.0, 1.0)) / PI
    return u, v


def _bilinear_wrap(img, u, v):
    """Bilinear sample with repeat addressing on both axes (the reference's
    environmentSampler, pathtrace.metal:20-23). Texel centers at +0.5."""
    import jax.numpy as jnp

    h, w = img.shape[0], img.shape[1]
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = jnp.mod(x0.astype(jnp.int32), w)
    x1i = jnp.mod(x0i + 1, w)
    y0i = jnp.mod(y0.astype(jnp.int32), h)
    y1i = jnp.mod(y0i + 1, h)
    c00 = img[y0i, x0i]
    c10 = img[y0i, x1i]
    c01 = img[y1i, x0i]
    c11 = img[y1i, x1i]
    top = c00 * (1.0 - fx) + c10 * fx
    bot = c01 * (1.0 - fx) + c11 * fx
    return top * (1.0 - fy) + bot * fy


def _bilinear_flat(env: EnvironmentSoA, level, u, v):
    """Bilinear sample of ONE per-lane-selected mip level from the flat
    atlas. level: (...,) i32 level index. Reproduces _bilinear_wrap's
    arithmetic exactly (same x/y/fx/fy math) with the level's
    (offset, h, w) gathered from the static metadata table (values
    < 2^24, exact in f32)."""
    import jax.numpy as jnp

    meta = jnp.asarray(env.mip_meta, jnp.float32)   # (L, 3): off, h, w
    sel = meta[level]                               # (..., 3)
    off = sel[..., 0].astype(jnp.int32)
    h = sel[..., 1]
    w = sel[..., 2]
    hi = h.astype(jnp.int32)
    wi = w.astype(jnp.int32)

    x = u * w - 0.5
    y = v * h - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = jnp.mod(x0.astype(jnp.int32), wi)
    y0i = jnp.mod(y0.astype(jnp.int32), hi)
    if _use_packed(env):
        # one 12-wide row gather: the quad atlas pre-packs the wrap
        # neighbours (values bit-identical to the four narrow gathers).
        q = env.flat_quads[off + y0i * wi + x0i]
        c00, c10, c01, c11 = (q[..., 0:3], q[..., 3:6],
                              q[..., 6:9], q[..., 9:12])
    else:
        x1i = jnp.mod(x0i + 1, wi)
        y1i = jnp.mod(y0i + 1, hi)
        flat = env.flat_mips
        c00 = flat[off + y0i * wi + x0i]
        c10 = flat[off + y0i * wi + x1i]
        c01 = flat[off + y1i * wi + x0i]
        c11 = flat[off + y1i * wi + x1i]
    top = c00 * (1.0 - fx) + c10 * fx
    bot = c01 * (1.0 - fx) + c11 * fx
    return top * (1.0 - fy) + bot * fy


def _bilinear_mip0(env: EnvironmentSoA, u, v):
    """Sharp (mip0) bilinear lookup; ONE quad-atlas row gather when the
    packed atlas exists, else the four-gather fallback. Bit-identical
    arithmetic to _bilinear_wrap(env.texels, u, v)."""
    import jax.numpy as jnp

    if not _use_packed(env):
        return _bilinear_wrap(env.texels, u, v)
    h, w = env.height, env.width
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = jnp.mod(x0.astype(jnp.int32), w)
    y0i = jnp.mod(y0.astype(jnp.int32), h)
    q = env.flat_quads[y0i * w + x0i]
    c00, c10, c01, c11 = (q[..., 0:3], q[..., 3:6],
                          q[..., 6:9], q[..., 9:12])
    top = c00 * (1.0 - fx) + c10 * fx
    bot = c01 * (1.0 - fx) + c11 * fx
    return top * (1.0 - fy) + bot * fy


def _sample_level(env: EnvironmentSoA, level: int):
    if level <= 0:
        return env.texels
    mips = env.mips
    return mips[min(level - 1, len(mips) - 1)]


def max_mip(env: EnvironmentSoA) -> float:
    return float(len(env.mips))


def environment_lod_from_roughness(roughness, env: EnvironmentSoA):
    """(reference: pathtrace.metal:1334-1344) lod = roughness^2 * maxMip"""
    import jax.numpy as jnp

    mm = max_mip(env)
    alpha = jnp.clip(roughness, 0.0, 1.0)
    return jnp.clip(alpha * alpha * mm, 0.0, mm)


def environment_color(env: EnvironmentSoA, direction, rotation, intensity,
                      static, lod=None):
    """Equirect lookup, optionally trilinear across the mip chain
    (reference: pathtrace.metal environment_color(_lod):1372-1407)."""
    import jax.numpy as jnp
    from metal_pathtracer.ops.integrator import to_working_space

    u, v = _direction_to_uv(direction, rotation)
    if lod is None:
        color = _bilinear_mip0(env, u, v)
    else:
        n_levels = len(env.mips) + 1
        lod = jnp.clip(lod, 0.0, float(n_levels - 1))
        lo = jnp.floor(lod).astype(jnp.int32)
        frac = (lod - lo.astype(jnp.float32))[..., None]
        if env.flat_mips is not None and len(env.mip_meta) == n_levels:
            # Flat-atlas path: gather ONLY the two adjacent levels (8 texel
            # rows) instead of sampling the whole pyramid and one-hot
            # selecting — same values, ~5x fewer gathers at 11 levels.
            # When every lane's lod is 0 (the common case: miss-path
            # backgrounds with no rough-specular history, alias radiance
            # on rough lanes), trilinear(0) == mip0 bilinear bit-exact, so
            # a real lax.cond halves the gathers again.
            import jax

            def _tri(_):
                c_lo = _bilinear_flat(env, lo, u, v)
                c_hi = _bilinear_flat(env, jnp.minimum(lo + 1, n_levels - 1),
                                      u, v)
                return c_lo * (1.0 - frac) + c_hi * frac

            def _bi(_):
                return _bilinear_mip0(env, u, v)

            color = jax.lax.cond(jnp.any(lod > 0.0), _tri, _bi, 0)
            color = color * intensity
            return to_working_space(color, static)
        else:
            # Fallback (hand-built EnvironmentSoA without the atlas):
            # gather every level, one-hot select.
            lo_colors = []
            for lev in range(n_levels):
                lo_colors.append(_bilinear_wrap(_sample_level(env, lev), u, v))
            stacked = jnp.stack(lo_colors, 0)  # (L, ..., 3)
            onehot_lo = (jnp.arange(n_levels) == lo[..., None])
            onehot_hi = (jnp.arange(n_levels) ==
                         jnp.minimum(lo + 1, n_levels - 1)[..., None])
            moved = jnp.moveaxis(stacked, 0, -2)  # (..., L, 3)
            c_lo = jnp.sum(moved * onehot_lo[..., None], -2)
            c_hi = jnp.sum(moved * onehot_hi[..., None], -2)
        color = c_lo * (1.0 - frac) + c_hi * frac
    color = color * intensity
    return to_working_space(color, static)


def environment_background(env: EnvironmentSoA, direction, uniforms, static,
                           env_lod, env_lod_active):
    """Miss-path background with optional roughness-carried LOD
    (reference: pathtrace.metal:5806-5830)."""
    import jax.numpy as jnp

    override = uniforms.debug_env_mip_override
    use_override = (override is not None)
    if len(env.mips) == 0:
        return environment_color(
            env, direction, uniforms.environment_rotation,
            uniforms.environment_intensity, static)
    # One trilinear call with lod forced to 0 on inactive lanes: trilinear
    # at lod=0 is bit-identical to the sharp bilinear (frac=0, finite
    # mips), so the old sharp/blurred double sample + select collapses to
    # half the gathers.
    lod = jnp.where(env_lod_active, env_lod, 0.0)
    if use_override:
        ov = jnp.maximum(override, 0.0)
        lod = jnp.where(override >= 0.0,
                        jnp.broadcast_to(ov, lod.shape), lod)
    return environment_color(env, direction, uniforms.environment_rotation,
                             uniforms.environment_intensity, static, lod=lod)


def environment_pdf(env: EnvironmentSoA, direction, rotation):
    """Per-texel solid-angle pdf gather
    (reference: pathtrace.metal environment_pdf:1444-1479)."""
    import jax.numpy as jnp

    u, v = _direction_to_uv(direction, rotation)
    u = jnp.clip(u, 0.0, _UCLAMP)
    v = jnp.clip(v, 0.0, _UCLAMP)
    w, h = env.width, env.height
    x = jnp.minimum((u * w).astype(jnp.int32), w - 1)
    y = jnp.minimum((v * h).astype(jnp.int32), h - 1)
    if _use_packed(env):
        value = env.cond_packed[y, x][..., 2]
    else:
        value = env.pdf[y, x]
    return jnp.where(jnp.isfinite(value) & (value > 0.0), value, 0.0)


def sample_environment(env: EnvironmentSoA, state, uniforms, static,
                       lighting_roughness):
    """Alias-table sample; 3 RNG draws per lane
    (reference: pathtrace.metal sample_environment:1494-1573 + the
    roughness-LOD radiance substitution at the call site :6568-1589).

    Returns (state, direction, radiance, pdf, valid).
    """
    state, u_marginal = rng_ops.rand_uniform(state)
    state, u_conditional = rng_ops.rand_uniform(state)
    state, u_jitter = rng_ops.rand_uniform(state)
    out = sample_environment_from_uniforms(
        env, u_marginal, u_conditional, u_jitter, uniforms, static,
        lighting_roughness)
    return (state,) + out


def sample_environment_from_uniforms(env: EnvironmentSoA, u_marginal,
                                     u_conditional, u_jitter, uniforms,
                                     static, lighting_roughness):
    """Deterministic alias-sample core given the three pre-drawn uniforms.
    Returns (direction, radiance, pdf, valid)."""
    import jax.numpy as jnp

    w, h = env.width, env.height
    row_choice = u_marginal * h
    row_floor = jnp.floor(row_choice)
    row = jnp.minimum(row_floor.astype(jnp.int32), h - 1)
    row_frac = row_choice - row_floor
    if _use_packed(env):
        mrow = env.marg_packed[row]                 # one 2-wide row gather
        row_threshold = mrow[..., 0]
        row_alias = mrow[..., 1].astype(jnp.int32)
    else:
        row_threshold = env.marginal_threshold[row]
        row_alias = env.marginal_alias[row]
    row = jnp.where(row_frac >= row_threshold,
                    jnp.minimum(row_alias, h - 1), row)

    col_choice = u_conditional * w
    col_floor = jnp.floor(col_choice)
    col = jnp.minimum(col_floor.astype(jnp.int32), w - 1)
    col_frac = col_choice - col_floor
    if _use_packed(env):
        crow = env.cond_packed[row, col]            # one 3-wide row gather
        col_threshold = crow[..., 0]
        col_alias = crow[..., 1].astype(jnp.int32)
    else:
        col_threshold = env.conditional_threshold[row, col]
        col_alias = env.conditional_alias[row, col]
    col = jnp.where(col_frac >= col_threshold,
                    jnp.minimum(col_alias, w - 1), col)

    fx = (col.astype(jnp.float32) + (u_conditional - jnp.floor(u_conditional))) / w
    fy = (row.astype(jnp.float32) + jnp.clip(u_jitter, 0.0, _UCLAMP)) / h

    theta = fy * PI
    # DEVIATION from the reference: it builds the sample direction with
    # phi = fx*2pi (pathtrace.metal:1543, EnvImportanceSampler.mm:212) while
    # every lookup maps direction->u via (atan2(z,x)+pi)/2pi
    # (pathtrace.metal:1383) — a half-map offset between the alias-sampled
    # texel and the radiance/pdf fetched for its direction. We use
    # phi = fx*2pi - pi so texel, pdf and radiance refer to the same
    # direction (validated by tests/test_env.py).
    phi = fx * (2.0 * PI) - PI
    sin_t = jnp.sin(theta)
    cos_t = jnp.cos(theta)
    map_dir = jnp.stack([sin_t * jnp.cos(phi), cos_t, sin_t * jnp.sin(phi)], -1)
    rot = uniforms.environment_rotation
    cos_r = jnp.cos(rot)
    sin_r = jnp.sin(rot)
    world_dir = jnp.stack([
        map_dir[..., 0] * cos_r + map_dir[..., 2] * sin_r,
        map_dir[..., 1],
        -map_dir[..., 0] * sin_r + map_dir[..., 2] * cos_r], -1)

    if _use_texel_nee(env):
        # Texel-exact NEE: ONE 4-wide row gather returns both the pdf and
        # the radiance the pdf was built from (schema.EnvironmentSoA
        # nee_packed note). Replaces the pdf gather + the direction->uv
        # re-projection (atan2/asin per lane) + the quad-atlas bilinear
        # (+roughness-LOD trilinear) fetch. Deviation from the reference's
        # jittered bilinear fetch (pathtrace.metal:1543-1573,6568-6589) is
        # within-texel variation only.
        from metal_pathtracer.ops.integrator import to_working_space
        if getattr(env, "nee_packed", None) is not None:
            nrow = env.nee_packed[row, col]
            pdf = nrow[..., 0]
            texel_rgb = nrow[..., 1:4]
        else:
            # hand-built EnvironmentSoA (tests): same estimator, two gathers
            pdf = env.pdf[row, col]
            texel_rgb = env.texels[row, col]
        radiance = to_working_space(
            texel_rgb * uniforms.environment_intensity, static)
    elif _use_packed(env):
        pdf = env.cond_packed[row, col][..., 2]
    else:
        pdf = env.pdf[row, col]

    # Radiance: mip-by-roughness when a mip chain exists (call-site logic,
    # reference: pathtrace.metal:6568-6589)
    if _use_texel_nee(env):
        pass
    elif len(env.mips) > 0:
        env_rough = jnp.clip(lighting_roughness, 0.0, 1.0)
        lod = environment_lod_from_roughness(env_rough, env)
        # lod forced to 0 on sharp lanes: trilinear(0) == bilinear mip0
        # bit-exact, so one call replaces the lod/sharp pair + select.
        lod = jnp.where(env_rough < 0.95, lod, 0.0)
        radiance = environment_color(
            env, world_dir, rot, uniforms.environment_intensity, static,
            lod=lod)
    else:
        radiance = environment_color(
            env, world_dir, rot, uniforms.environment_intensity, static)

    valid = jnp.isfinite(pdf) & (pdf > 0.0) & jnp.all(jnp.isfinite(radiance), -1)
    radiance = jnp.maximum(radiance, 0.0)
    return world_dir, radiance, jnp.where(valid, pdf, 0.0), valid
