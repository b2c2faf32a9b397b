#!/usr/bin/env python
"""Time the denoiser tiers at 1080p on the device. Synthetic HDR inputs
— the cost is shape-dependent only. Median of 5 after warm-up, each call
ended with block_until_ready."""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from metal_pathtracer.utils.compilecache import enable_cache

enable_cache()


def timeit(label, fn, *args):
    import jax
    import jax.numpy as jnp

    f = jax.jit(lambda *a: jnp.sum(fn(*a)))
    t0 = time.time()
    f(*args).block_until_ready()
    compile_s = time.time() - t0
    ts = []
    for _ in range(5):
        t0 = time.time()
        f(*args).block_until_ready()
        ts.append(time.time() - t0)
    ts.sort()
    print(f"{label:28s} {ts[len(ts)//2]*1e3:8.1f} ms @1080p "
          f"(compile {compile_s:.1f}s)", flush=True)


def main():
    import jax.numpy as jnp

    from metal_pathtracer.ops import denoise
    from metal_pathtracer.ops.denoise import _learned_params, _unet_params
    from metal_pathtracer.ops import denoise_unet

    rng = np.random.default_rng(0)
    h, w = 1080, 1920
    color = jnp.asarray(rng.gamma(2.0, 0.5, (h, w, 3)), jnp.float32)
    albedo = jnp.asarray(rng.random((h, w, 3)), jnp.float32)
    normal = jnp.asarray(rng.normal(size=(h, w, 3)), jnp.float32)
    normal = normal / jnp.linalg.norm(normal, axis=-1, keepdims=True)
    var = jnp.asarray(rng.random((h, w, 3)), jnp.float32) * 0.05

    # pass every array as a jit ARG — closure arrays are baked into the
    # program as literals (observed: 75 MB MLIR, compile-helper OOM-kill)
    timeit("atrous (fixed sigma)",
           lambda c, a, n: denoise.atrous_denoise(c, a, n),
           color, albedo, normal)
    timeit("svgf (variance-guided)",
           lambda c, a, n, v: denoise.svgf_denoise(c, a, n, v),
           color, albedo, normal, var)
    lp = _learned_params()
    if lp is not None:
        timeit("learned taps",
               lambda c, a, n, v: denoise.learned_denoise(c, a, n, v, lp),
               color, albedo, normal, var)
        up = _unet_params()
        if up is not None:
            base = denoise.learned_denoise(color, albedo, normal, var, lp)
            timeit("conv U-Net refinement",
                   lambda c, a, n, v, b: denoise_unet.denoise(
                       c, a, n, v, up, b),
                   color, albedo, normal, var, base)


if __name__ == "__main__":
    main()
