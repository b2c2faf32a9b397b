"""Jitted frame stepping: N samples of progressive accumulation.

The counterpart of the reference's encodeFrame/encodeIntegration per-sample
dispatch loop (reference: src/renderer/RenderLoop.mm:367-391): a single
jitted function advances the RenderState by `n_samples`, with the pixel
wavefront processed in fixed-size chunks (bounds the lanes x primitives
working set in device memory, the way the reference bounds it by dispatch
width).

`render_rows` is the shard-local core: it renders a horizontal slab at a
given global row offset, which is how parallel/mesh.py maps the image
across a device mesh while keeping images bit-identical to one device
(RNG is seeded by absolute pixel id).
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

from metal_pathtracer.ops import integrator
from metal_pathtracer.renderer.accumulation import RenderState
from metal_pathtracer.schema import SceneArrays, StaticConfig, Uniforms

# Lanes per integrator chunk: brute-force (lanes x prims) buffers stay well
# inside device memory, and a chunk whose lanes all terminate early ends
# its depth loop early. Not yet tuned on the GPU.
DEFAULT_CHUNK = 262144

# Pixel tiles of 8 rows x 128 columns: lanes are laid out tile by tile, so
# a traversal kernel block (ops/pallas/traverse.py) and each warp inside
# it hold rays from one small screen region. Neighbouring rays visit the
# same BVH nodes, so tile order buys warp coherence.
TILE_H, TILE_W = 8, 128


def _pixel_order(slab_h: int, width: int, batch: int = 1):
    """Flat lane -> pixel mapping in tile order (scan order fallback).

    batch=1: one lane per pixel, tiles of TILE_H x TILE_W. batch=B>1
    (cross-sample batching): each 1024-lane tile holds B jittered
    sample-copies of a (TILE_H//B x TILE_W) pixel strip, sample-major —
    bounce rays that left the same small screen region share BVH subtrees.

    Returns (x_lanes, y_lanes, b_lanes, inverse_perm) as numpy arrays.
    With batch=B the lane order is (tile, b, strip_pixel); collapse the B
    copies with lanes.reshape(-1, B, strip)...sum(axis 1) and scatter the
    per-pixel result with inverse_perm: img_flat = pixels[inverse_perm].
    """
    total = slab_h * width
    strip_h = max(TILE_H // batch, 1)
    if slab_h % strip_h == 0 and width % TILE_W == 0:
        ty, tx = np.meshgrid(np.arange(slab_h // strip_h),
                             np.arange(width // TILE_W), indexing="ij")
        py, px = np.meshgrid(np.arange(strip_h), np.arange(TILE_W),
                             indexing="ij")
        # pixels ordered strip-by-strip, row-major within the strip
        y = (ty.reshape(-1, 1) * strip_h + py.reshape(1, -1)).reshape(-1)
        x = (tx.reshape(-1, 1) * TILE_W + px.reshape(1, -1)).reshape(-1)
    else:
        if batch != 1:
            raise ValueError(
                f"sample batch {batch} needs slab_h % {strip_h} == 0 and "
                f"width % {TILE_W} == 0 (got {slab_h}x{width})")
        flat = np.arange(total)
        x = flat % width
        y = flat // width
    perm = y * width + x                      # pixel-slot -> pixel
    inverse = np.empty(total, np.int64)
    inverse[perm] = np.arange(total)          # pixel -> pixel-slot
    if batch == 1:
        b = np.zeros(total, np.uint32)
        return x.astype(np.uint32), y.astype(np.uint32), b, inverse
    strip = strip_h * TILE_W
    n_strips = total // strip
    xs = np.broadcast_to(x.reshape(n_strips, 1, strip),
                         (n_strips, batch, strip)).reshape(-1)
    ys = np.broadcast_to(y.reshape(n_strips, 1, strip),
                         (n_strips, batch, strip)).reshape(-1)
    bs = np.broadcast_to(np.arange(batch, dtype=np.uint32)[None, :, None],
                         (n_strips, batch, strip)).reshape(-1)
    return xs.astype(np.uint32), ys.astype(np.uint32), bs, inverse


def render_rows(scene: SceneArrays, uniforms: Uniforms, state: RenderState,
                static: StaticConfig, n_samples: int, row_offset,
                chunk: int = DEFAULT_CHUNK,
                sample_batch: int = 1) -> RenderState:
    """Advance a slab of rows by n_samples. `state` covers the slab; pixel
    coordinates are global (slab row 0 is image row `row_offset`), so the
    result is invariant to how the image is sliced across devices.

    sample_batch=B>1 traces B consecutive sample ordinals of each pixel in
    one wavefront (each 1024-lane tile = B jittered copies of a
    TILE_H//B x TILE_W pixel strip). Per-sample RNG streams are identical
    to B=1 — only the float accumulation order differs (the B copies are
    reduced pairwise instead of sequentially)."""
    if n_samples <= 0:
        return state
    B = sample_batch
    if n_samples % B != 0:
        raise ValueError(f"n_samples {n_samples} not divisible by "
                         f"sample_batch {B}")
    slab_h, width = state.height, state.width
    total = slab_h * width
    lanes_total = total * B
    chunk = min(chunk, lanes_total)
    padded = ((lanes_total + chunk - 1) // chunk) * chunk
    x_np, y_np, b_np, inverse_np = _pixel_order(slab_h, width, B)
    if padded > lanes_total:
        # padding lanes redo the last pixel; sliced off before scatter
        x_np = np.concatenate([x_np, np.full(padded - lanes_total, x_np[-1])])
        y_np = np.concatenate([y_np, np.full(padded - lanes_total, y_np[-1])])
        b_np = np.concatenate([b_np, np.full(padded - lanes_total, b_np[-1])])
    xs = jnp.asarray(x_np.astype(np.uint32)).reshape(-1, chunk)
    ys_local = jnp.asarray(y_np.astype(np.uint32)).reshape(-1, chunk)
    bs = jnp.asarray(b_np.astype(np.uint32)).reshape(-1, chunk)
    inverse_perm = jnp.asarray(inverse_np)
    n_chunks = xs.shape[0]

    # Per-lane prev counts and running radiance, fetched ONCE per call
    # rather than permuted per sample. Seeding the lane accumulator from
    # the existing sum keeps the per-pixel float addition sequence
    # identical to per-sample accumulation, so checkpoint resume stays
    # bit-exact.
    lane_idx = jnp.minimum(
        jnp.asarray(y_np.astype(np.int64) * width + x_np.astype(np.int64)),
        total - 1)
    prev_lane0 = (state.sample_count.reshape(-1)[lane_idx]
                  + b_np.astype(np.uint32)).reshape(-1, chunk)
    # copy b=0 seeds from the running sum; copies b>0 start at zero so the
    # final cross-copy reduction counts the prior sum exactly once
    b0 = (b_np == 0)[:, None]
    lane_rad0 = jnp.where(b0, state.radiance_sum.reshape(-1, 3)[lane_idx],
                          0.0)
    sq_sum = state.radiance_sq_sum if state.radiance_sq_sum is not None \
        else jnp.zeros_like(state.radiance_sum)
    lane_sq0 = jnp.where(b0, sq_sum.reshape(-1, 3)[lane_idx], 0.0)

    def one_group(i, carry):
        # Per-dispatch uniforms: frameIndex == sampleCount == dispatch index
        # (reference: Accumulation.h incrementFrame:54-57, UniformBuilder.mm:31-33);
        # batched lanes add their ordinal offset b in integrate_pixels.
        lane_rad, lane_sq, lane_alb, lane_nrm, frame_idx, n_rays, \
            n_shadow = carry
        u = uniforms.replace(frame_index=frame_idx, sample_count=frame_idx)

        def do_chunk(coords):
            x, y_local, b, prev = coords
            y = y_local + jnp.uint32(row_offset)
            return integrator.integrate_pixels(
                scene, u, static, x, y,
                prev + (i.astype(jnp.uint32) * jnp.uint32(B)),
                frame_offset=None if B == 1 else b)

        if n_chunks == 1:
            sample, albedo, normal, stats = do_chunk(
                (xs[0], ys_local[0], bs[0], prev_lane0[0]))
            sample, albedo, normal = sample[None], albedo[None], normal[None]
            stats = jax.tree_util.tree_map(lambda v: v[None], stats)
        else:
            sample, albedo, normal, stats = jax.lax.map(
                do_chunk, (xs, ys_local, bs, prev_lane0))

        s = sample.reshape(-1, 3)
        return (lane_rad + s, lane_sq + s * s,
                albedo.reshape(-1, 3), normal.reshape(-1, 3),
                frame_idx + jnp.uint32(B),
                n_rays + jnp.sum(stats["rays"]),
                n_shadow + jnp.sum(stats["shadow_rays"]))

    z_lane = jnp.zeros((padded, 3), jnp.float32)
    lane_rad, lane_sq, lane_alb, lane_nrm, frame_idx, n_rays, n_shadow = \
        jax.lax.fori_loop(
            0, n_samples // B, one_group,
            (lane_rad0, lane_sq0, z_lane, z_lane, state.frame_index,
             state.ray_count, state.shadow_ray_count))

    # Lanes are in tile order; the static inverse permutation restores
    # scan-order pixels ONCE per call (a pure gather — no duplicate
    # writes). For B>1 the B sample-copies of each pixel strip are
    # collapsed first (sum for accumulators, last ordinal for AOVs).
    def collapse_sum(v):
        if B == 1:
            return v[:total][inverse_perm].reshape(slab_h, width, 3)
        strip = (TILE_H // B) * TILE_W
        per_pixel = v[:lanes_total].reshape(-1, B, strip, 3).sum(axis=1)
        return per_pixel.reshape(total, 3)[inverse_perm] \
            .reshape(slab_h, width, 3)

    def collapse_last(v):
        if B == 1:
            return v[:total][inverse_perm].reshape(slab_h, width, 3)
        strip = (TILE_H // B) * TILE_W
        per_pixel = v[:lanes_total].reshape(-1, B, strip, 3)[:, B - 1]
        return per_pixel.reshape(total, 3)[inverse_perm] \
            .reshape(slab_h, width, 3)

    return state.replace(
        radiance_sum=collapse_sum(lane_rad),
        radiance_sq_sum=collapse_sum(lane_sq),
        sample_count=state.sample_count + jnp.uint32(n_samples),
        albedo=collapse_last(lane_alb),
        normal=collapse_last(lane_nrm),
        frame_index=frame_idx,
        ray_count=n_rays,
        shadow_ray_count=n_shadow,
    )


@functools.partial(jax.jit, static_argnames=("static", "n_samples", "chunk"))
def _render_samples_jit(scene: SceneArrays, uniforms: Uniforms,
                        state: RenderState, static: StaticConfig,
                        n_samples: int,
                        chunk: int = DEFAULT_CHUNK) -> RenderState:
    return render_rows(scene, uniforms, state, static, n_samples, 0, chunk)


@functools.partial(jax.jit, static_argnames=("static", "n_samples", "chunk",
                                             "sample_batch"))
def _render_slab_jit(scene: SceneArrays, uniforms: Uniforms,
                     state: RenderState, static: StaticConfig,
                     n_samples: int, row_offset,
                     chunk: int = DEFAULT_CHUNK,
                     sample_batch: int = 1) -> RenderState:
    # row_offset is traced so all B slabs share one executable
    return render_rows(scene, uniforms, state, static, n_samples,
                       row_offset, chunk, sample_batch)


# Samples per device dispatch. Splitting a render into several dispatches
# is bit-exact vs one dispatch (per-lane accumulation seeds from the
# running sums — the same float addition sequence) and bounds the trip
# count, and so the compile time, of each frame program. Not yet tuned on
# the GPU. Read at CALL time.
def max_spp_per_dispatch() -> int:
    return int(os.environ.get("MPT_MAX_SPP_PER_DISPATCH", "8"))


def _sample_batch_for(height: int, width: int, n_samples: int) -> int:
    """Largest usable cross-sample batch B for this frame, from
    MPT_SAMPLE_BATCH (default 1): needs B | TILE_H, B | height,
    (height//B) % (TILE_H//B) == 0, width % TILE_W == 0, B | n_samples."""
    B = int(os.environ.get("MPT_SAMPLE_BATCH", "1"))
    while B > 1:
        if (TILE_H % B == 0 and height % B == 0 and width % TILE_W == 0
                and (height // B) % (TILE_H // B) == 0
                and n_samples % B == 0):
            return B
        B //= 2
    return 1


def render_samples(scene: SceneArrays, uniforms: Uniforms, state: RenderState,
                   static: StaticConfig, n_samples: int,
                   chunk: int = DEFAULT_CHUNK) -> RenderState:
    """Single-device: advance the full frame by n_samples.

    Host-side wrapper over the jitted step; dispatches at most
    MAX_SPP_PER_DISPATCH samples per device program (see note above).

    With MPT_SAMPLE_BATCH=B>1 (cross-sample batching) each dispatch
    renders B samples of a height//B row slab, so a wavefront still has
    ~height*width lanes but every tile covers a B-times-smaller pixel
    strip — the per-sample images are RNG-identical to B=1; only the
    float accumulation order differs.
    """
    B = _sample_batch_for(state.height, state.width, n_samples)
    if B > 1:
        slab_h = state.height // B
        groups_per_dispatch = max(1, max_spp_per_dispatch())
        done = 0
        while done < n_samples:
            take = min(groups_per_dispatch * B, n_samples - done)
            frame0 = state.frame_index
            rays, shadow = state.ray_count, state.shadow_ray_count
            rows = {"radiance_sum": [], "radiance_sq_sum": [],
                    "sample_count": [], "albedo": [], "normal": []}
            out = None
            for s in range(B):
                lo, hi = s * slab_h, (s + 1) * slab_h
                slab = state.replace(
                    radiance_sum=state.radiance_sum[lo:hi],
                    radiance_sq_sum=None if state.radiance_sq_sum is None
                    else state.radiance_sq_sum[lo:hi],
                    sample_count=state.sample_count[lo:hi],
                    albedo=state.albedo[lo:hi],
                    normal=state.normal[lo:hi],
                    denoised=None,
                    frame_index=frame0,
                    ray_count=rays, shadow_ray_count=shadow)
                out = _render_slab_jit(scene, uniforms, slab, static, take,
                                       jnp.uint32(lo), chunk, B)
                rays, shadow = out.ray_count, out.shadow_ray_count
                for k in rows:
                    rows[k].append(getattr(out, k))
            state = state.replace(
                frame_index=out.frame_index,
                ray_count=rays, shadow_ray_count=shadow,
                **{k: jnp.concatenate(v, axis=0) for k, v in rows.items()})
            done += take
        return state
    step = max(1, max_spp_per_dispatch())
    while n_samples > 0:
        take = min(step, n_samples)
        state = _render_samples_jit(scene, uniforms, state, static, take,
                                    chunk)
        n_samples -= take
    return state
