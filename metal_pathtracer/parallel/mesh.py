"""Multi-chip scaling: `shard_map` the pixel wavefront over a device mesh.

The reference is single-node, single-GPU (SURVEY.md §2.4); this module is
the new first-class distributed layer: data parallelism over pixels on a
1-D mesh (every card reaches every other over NVLink, so the mesh follows
the algorithm alone), replicated scene buffers, `psum` only for stats.
Determinism across shardings comes from the reference's absolute
pixel/sample RNG seeding (pathtrace.metal:9735-9740) — a 1-chip and an
N-chip render of the same frame are bit-identical.

Multi-host extension: call `jax.distributed.initialize()` before building
the mesh and this module works unchanged over DCN process groups.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from metal_pathtracer.renderer.accumulation import RenderState
from metal_pathtracer.renderer.frame import DEFAULT_CHUNK, render_rows
from metal_pathtracer.schema import SceneArrays, StaticConfig, Uniforms

AXIS = "pixels"


def make_mesh(devices=None) -> Mesh:
    """1-D mesh over all local devices."""
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (AXIS,))


def _state_specs(replicated_scalars=True):
    """PartitionSpec pytree for RenderState: images row-sharded, counters
    replicated (they are psum'd inside the shard body)."""
    img = P(AXIS)
    scalar = P()
    return RenderState(
        radiance_sum=img, sample_count=img, albedo=img, normal=img,
        frame_index=scalar, denoised=img,
        ray_count=scalar, shadow_ray_count=scalar,
        radiance_sq_sum=img)


def shard_state(state: RenderState, mesh: Mesh) -> RenderState:
    """Place a host RenderState onto the mesh with row sharding.

    Non-divisible heights are padded with extra rows so every device gets
    an equal slab; the pad rows hold off-screen pixels and are sliced off
    by `unpad_state` / at save time."""
    n_dev = mesh.devices.size
    if state.radiance_sq_sum is None:
        # pre-sq_sum checkpoint: the spec pytree needs a real leaf
        state = state.replace(
            radiance_sq_sum=jnp.zeros_like(state.radiance_sum))
    h = state.radiance_sum.shape[0]
    pad = (-h) % n_dev
    if pad:
        def pad_img(x):
            if x is None:
                return None
            return jnp.pad(x, ((0, pad),) + ((0, 0),) * (x.ndim - 1))
        state = state.replace(
            radiance_sum=pad_img(state.radiance_sum),
            sample_count=pad_img(state.sample_count),
            albedo=pad_img(state.albedo), normal=pad_img(state.normal),
            denoised=pad_img(state.denoised),
            radiance_sq_sum=pad_img(state.radiance_sq_sum))
    specs = _state_specs()
    return jax.tree_util.tree_map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), state, specs)


def unpad_state(state: RenderState, height: int) -> RenderState:
    """Slice a (possibly pad-row-carrying) state back to the true image."""
    def cut(x):
        return None if x is None else x[:height]
    return state.replace(
        radiance_sum=cut(state.radiance_sum),
        sample_count=cut(state.sample_count),
        albedo=cut(state.albedo), normal=cut(state.normal),
        denoised=cut(state.denoised),
        radiance_sq_sum=cut(state.radiance_sq_sum))


def replicate(tree, mesh: Mesh):
    """Broadcast scene/uniforms pytrees to every device."""
    return jax.tree_util.tree_map(
        lambda x: jax.device_put(x, NamedSharding(mesh, P())), tree)


@functools.partial(jax.jit,
                   static_argnames=("static", "n_samples", "mesh", "chunk"))
def render_samples_sharded(scene: SceneArrays, uniforms: Uniforms,
                           state: RenderState, static: StaticConfig,
                           n_samples: int, mesh: Mesh,
                           chunk: int = DEFAULT_CHUNK) -> RenderState:
    """N-device progressive render step.

    Splits the spp loop across dispatches exactly like
    renderer.frame.render_samples does (bit-exact; see the
    max_spp_per_dispatch note there).
    """
    from metal_pathtracer.renderer.frame import max_spp_per_dispatch

    step = max(1, max_spp_per_dispatch())
    while n_samples > 0:
        take = min(step, n_samples)
        state = _render_sharded_once(scene, uniforms, state, static, take,
                                     mesh, chunk)
        n_samples -= take
    return state


def _render_sharded_once(scene: SceneArrays, uniforms: Uniforms,
                         state: RenderState, static: StaticConfig,
                         n_samples: int, mesh: Mesh,
                         chunk: int = DEFAULT_CHUNK) -> RenderState:
    """One sharded dispatch: image rows are split evenly across the mesh
    (state height must divide by the mesh size); each device renders its
    slab with global pixel coordinates; ray counters are `psum`'d so every
    device carries the global totals.
    """
    n_dev = mesh.devices.size
    state_rows = state.radiance_sum.shape[0]
    if state_rows % n_dev != 0:
        raise ValueError(
            f"sharded state carries {state_rows} rows, not divisible by "
            f"mesh size {n_dev} — build it with mesh.shard_state (which "
            "pads non-divisible heights)")
    rows_per_dev = state_rows // n_dev
    # Pad rows (state_rows > static.height) are off-screen pixels below
    # the image; per-pixel RNG is seeded by absolute pixel id so they
    # cannot change any real pixel (SURVEY.md §5.8). Slice with
    # `unpad_state` before presenting/saving.

    def shard_fn(scene, uniforms, st: RenderState) -> RenderState:
        row0 = jax.lax.axis_index(AXIS).astype(jnp.uint32) * rows_per_dev
        out = render_rows(scene, uniforms, st, static, n_samples, row0, chunk)
        return out.replace(
            ray_count=jax.lax.psum(out.ray_count - st.ray_count, AXIS)
            + st.ray_count,
            shadow_ray_count=jax.lax.psum(
                out.shadow_ray_count - st.shadow_ray_count, AXIS)
            + st.shadow_ray_count,
        )

    specs = _state_specs()
    return jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(), P(), specs),
        out_specs=specs,
        check_vma=False,
    )(scene, uniforms, state)


def gather_state(state: RenderState) -> RenderState:
    """Pull a sharded RenderState back to host memory (save/present time —
    the only cross-device gather in the pipeline, SURVEY.md §2.4)."""
    return jax.tree_util.tree_map(
        lambda x: jax.device_get(x) if x is not None else None, state)
