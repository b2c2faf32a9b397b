#!/usr/bin/env python
"""Traversal kernel vs plain-XLA traversal on the card, at the chunk width
and end to end, with a profiler trace of each.

    python tools/traversal_ab.py [--out DIR]

For each route ("kernel", "xla"): one integrator chunk of headline camera
rays traced alone, and the headline frame (1920x1080, maxDepth 8) rendered
through JaxBackend at --spp samples after a warm-up. Each measurement is
then repeated under jax.profiler (for the frame: the sample loop over a
prebuilt scene); the trace is reduced to the device's busy share of the
traced wall time and its top kernels by device time.
Prints one JSON line per measurement; with --out, also writes
DIR/summary.json.
Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402


def _union_ns(intervals):
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def trace_summary(trace_dir: str, wall_s: float, top: int = 8) -> dict:
    """Device busy share over the traced wall time and the top kernels by
    summed device duration, from the xplane.pb under trace_dir."""
    from jax.profiler import ProfileData

    paths = [os.path.join(r, f) for r, _, fs in os.walk(trace_dir)
             for f in fs if f.endswith(".xplane.pb")]
    pd = ProfileData.from_file(sorted(paths)[-1])
    intervals, by_name, lines = [], {}, set()
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if not line.name.startswith("Stream"):
                continue
            lines.add(line.name)
            for ev in line.events:
                intervals.append((ev.start_ns, ev.start_ns + ev.duration_ns))
                by_name[ev.name] = by_name.get(ev.name, 0) + ev.duration_ns
    busy = _union_ns(intervals)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {
        "wall_s": wall_s,
        "device_busy_s": busy * 1e-9,
        "idle_share": 1.0 - busy * 1e-9 / wall_s,
        "kernel_launches": len(intervals),
        "stream_lines": sorted(lines),
        "top_kernels_ms": {k[:80]: v * 1e-6 for k, v in ranked},
    }


def traced(fn) -> dict:
    import jax

    fn()  # warm
    with tempfile.TemporaryDirectory() as tmp:
        jax.profiler.start_trace(tmp)
        t0 = time.perf_counter()
        fn()
        wall = time.perf_counter() - t0
        jax.profiler.stop_trace()
        return trace_summary(tmp, wall)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=None)
    p.add_argument("--spp", type=int, default=4)
    p.add_argument("--trace-spp", type=int, default=1,
                   help="samples in the traced frame (the XLA route emits "
                        "~500k kernels per sample; more overflow the "
                        "profiler's event buffers)")
    args = p.parse_args(argv)
    if args.out:
        os.makedirs(args.out, exist_ok=True)

    import jax

    from metal_pathtracer.constants import EPSILON_T, INFINITY_T
    from metal_pathtracer.ops import traversal
    from metal_pathtracer.renderer.accumulation import RenderState
    from metal_pathtracer.renderer.frame import DEFAULT_CHUNK, render_samples
    from metal_pathtracer.renderer.headless import JaxBackend
    from metal_pathtracer.utils import routecheck
    from metal_pathtracer.utils.benchscene import build_bench_scene, \
        frame_inputs
    from metal_pathtracer.utils.compilecache import enable_cache

    assert jax.devices()[0].platform == "gpu", "needs a GPU"
    enable_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    settings, res, env = build_bench_scene(8)
    scene = res.build_arrays(environment=env, traversal="kernel")
    o, d = routecheck.chunk_rays(settings, 1920, 1080, DEFAULT_CHUNK)
    tmax = np.full((DEFAULT_CHUNK,), INFINITY_T, np.float32)
    summary = {"card": card, "spp": args.spp, "trace_spp": args.trace_spp}

    for route in ("kernel", "xla"):
        tables = scene.tri_kernel if route == "kernel" else None
        fn = jax.jit(lambda o_, d_, t_, tables=tables: traversal.trace_best(
            o_, d_, scene.triangles, scene.tri_bvh, tables, EPSILON_T, t_))
        call = lambda fn=fn: jax.block_until_ready(fn(o, d, tmax))
        rec = {"route": route, "what": f"chunk trace {DEFAULT_CHUNK} lanes",
               "ms": 1e3 * routecheck.time_call(call)}
        rec["trace"] = traced(call)
        print(json.dumps(rec), flush=True)
        summary[f"{route}_chunk"] = rec

        backend = JaxBackend(route)
        t0 = time.perf_counter()
        backend.render(res, settings, 1920, 1080, args.spp, environment=env)
        first = time.perf_counter() - t0
        out = backend.render(res, settings, 1920, 1080, args.spp,
                             environment=env)
        rec = {"route": route, "what": f"frame 1920x1080 {args.spp} spp",
               "ms_per_sample": out.avg_ms_per_sample,
               "mrays_per_s": (out.rays + out.shadow_rays)
               / out.total_seconds / 1e6,
               "setup_s": first - out.total_seconds,
               "rays": out.rays, "shadow_rays": out.shadow_rays}
        # trace the sample loop alone (the scene is built outside it)
        scene_r, static, uni = frame_inputs(settings, res, env, 1920, 1080,
                                            route)

        def frame(scene_r=scene_r):
            st = render_samples(scene_r, uni, RenderState.create(1920, 1080),
                                static, args.trace_spp)
            return jax.block_until_ready(st.radiance_sum)
        rec["trace"] = traced(frame)
        print(json.dumps(rec), flush=True)
        summary[f"{route}_frame"] = rec

    if args.out:
        with open(os.path.join(args.out, "summary.json"), "w") as fh:
            json.dump(summary, fh, indent=1)
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
