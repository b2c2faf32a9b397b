"""Per-pixel path probe: the counterpart of the reference's debug ring
buffer (512-entry `PathtraceDebugBuffer`, reference:
include/MetalShaderTypes.h:270-287, shaders/pathtrace.metal:258-492,
RenderLoop.mm:514-540).

Instead of an in-kernel ring written by one probed GPU thread, the
functional wavefront re-traces the probe pixel's sample with per-bounce
recording enabled and returns the full bounce history as structured rows
— same information, idiomatic JAX (no side-effect buffers).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from metal_pathtracer.ops import camera as camera_ops
from metal_pathtracer.ops import rng as rng_ops
from metal_pathtracer.ops.integrator import PROBE_FIELDS, trace_paths


def probe_pixel(scene, uniforms, static, x: int, y: int,
                prev_count: int = 0):
    """Replay one pixel's sample and return its bounce history.

    Returns a list of dicts (one per bounce that executed) with keys
    PROBE_FIELDS plus "depth" — hit ids, t, throughput, radiance-so-far,
    medium events, pdf, delta flag. Deterministic: same (pixel, seed,
    sample index) recipe as the render itself (rng.make_seed), so the
    probe replays exactly what the accumulated frame traced.
    """
    xs = jnp.asarray([x], jnp.uint32)
    ys = jnp.asarray([y], jnp.uint32)
    prev = jnp.asarray([prev_count], jnp.uint32)
    seed = rng_ops.make_seed(uniforms.fixed_rng_seed, uniforms.frame_index,
                             xs, ys, uniforms.sample_count, prev)
    state, origin, direction = camera_ops.generate_primary_rays(
        uniforms.camera, xs, ys, static.width, static.height, seed)
    out = trace_paths(scene, uniforms, static, state, origin, direction,
                      record_probe=True)
    records = np.asarray(out[5])[:, 0, :]  # (max_depth, 16), lane 0

    rows = []
    for depth in range(records.shape[0]):
        row = dict(zip(PROBE_FIELDS, records[depth]))
        # all-zero rows past termination are padding, except depth 0
        if depth > 0 and not np.any(records[depth]):
            break
        row["depth"] = depth
        rows.append(row)
    return rows
