#!/usr/bin/env python
"""maxDepth sweep on the headline scene, interleaved in ONE process
(compare configurations only within one process on one card).

Splits a sample's cost by depth: the depth-d time includes depths
0..d-1, so consecutive differences are per-depth costs under the CURRENT
defaults. Usage: python tools/depthsweep.py
[depths...] (default 1 2 4 8).
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from metal_pathtracer.utils.compilecache import enable_cache

enable_cache()


def main():
    import jax

    from metal_pathtracer.renderer import frame
    from metal_pathtracer.renderer.accumulation import RenderState
    from metal_pathtracer.utils.benchscene import build_bench_scene, \
        frame_inputs

    depths = [int(a) for a in sys.argv[1:]] or [1, 2, 4, 8]
    spp, rounds = 2, 3
    settings, res, env = build_bench_scene(8)

    fns = {}
    for d in depths:
        settings.maxDepth = d
        scene, static, uniforms = frame_inputs(settings, res, env, 1920,
                                               1080)

        @jax.jit
        def run(scene, uniforms, state, _static=static):
            return frame.render_rows(scene, uniforms, state, _static, spp,
                                     0, chunk=262144)

        state0 = RenderState.create(static.width, static.height)
        t0 = time.time()
        out = run(scene, uniforms, state0)
        np.asarray(out.radiance_sum)
        print(f"compile+first depth={d}: {time.time()-t0:.1f}s", flush=True)
        fns[d] = (run, scene, uniforms, state0)

    results = {d: [] for d in depths}
    for r in range(rounds):
        for d, (run, scene, uniforms, state0) in fns.items():
            st = run(scene, uniforms, state0)  # warm
            rays0 = float(np.asarray(st.ray_count)) + float(
                np.asarray(st.shadow_ray_count))
            t0 = time.time()
            st = run(scene, uniforms, st)
            rays1 = float(np.asarray(st.ray_count)) + float(
                np.asarray(st.shadow_ray_count))
            np.asarray(st.radiance_sum)
            dt = time.time() - t0
            results[d].append(dt / spp)
            print(f"  round {r} depth={d}: {dt/spp*1000:.0f} ms/sample "
                  f"{(rays1-rays0)/dt/1e6:.2f} Mrays/s", flush=True)

    print("\n=== medians (ms/sample) ===")
    prev = 0.0
    for d in depths:
        m = sorted(results[d])[len(results[d]) // 2] * 1000
        print(f"depth {d}: {m:8.0f}   (delta vs prev listed: {m-prev:+.0f})")
        prev = m


if __name__ == "__main__":
    main()
