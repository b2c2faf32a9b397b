#!/usr/bin/env python
"""Benchmark driver — prints ONE JSON line with the headline metric.

Metric: Mrays/s (closest-hit + shadow scene traces) at 1080p / maxDepth 8
on one GPU. The headline scene (utils/benchscene.py) is a 1.31M-triangle
displaced icosphere (Stanford-Dragon-class, generated — no downloads) plus
a glass dielectric and a textured-PBR sphere on a ground plane under an
HDR sun/sky environment with alias-table NEE.

The selfcheck (on by default) compares the traversal kernel with the
plain-XLA traversal on one chunk of headline camera rays
(utils/routecheck.py) and stamps "parity_ok" into the JSON.

    python bench.py [--scene dragon|lambert|refdefault] [--spp N]
                    [--traversal kernel|xla]

--traversal xla times the plain-XLA traversal route on the card.
Fails unless JAX's default device is a GPU.
"""

import argparse
import json
import subprocess
import sys
import time

import numpy as np


def _rays_of(state):
    return float(np.asarray(state.ray_count)) + \
        float(np.asarray(state.shadow_ray_count))


def _median_rate(frame, scene, uniforms, state, static, spp, reps):
    samples = []
    for _ in range(reps):
        before = _rays_of(state)
        t0 = time.perf_counter()
        state = frame.render_samples(scene, uniforms, state, static, spp)
        state.radiance_sum.block_until_ready()
        elapsed = time.perf_counter() - t0
        samples.append(((_rays_of(state) - before) / elapsed / 1e6, elapsed))
    rates = sorted(r for r, _ in samples)
    elapsed = sorted(e for _, e in samples)[len(samples) // 2]
    return rates[len(rates) // 2], elapsed, rates


def _selfcheck(settings, resources, environment) -> bool:
    """Traversal kernel vs XLA traversal on one integrator chunk of
    headline camera rays (tolerances: utils/routecheck.py)."""
    from metal_pathtracer.constants import EPSILON_T, INFINITY_T
    from metal_pathtracer.renderer.frame import DEFAULT_CHUNK
    from metal_pathtracer.utils import routecheck

    scene = resources.build_arrays(environment=environment,
                                   traversal="kernel")
    o, d = routecheck.chunk_rays(settings, 1920, 1080, DEFAULT_CHUNK)
    tmax = np.full((DEFAULT_CHUNK,), INFINITY_T, np.float32)
    r = routecheck.compare(scene, o, d, EPSILON_T, tmax)
    print(f"# selfcheck {json.dumps(r)}", file=sys.stderr)
    return r["ok"]


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--no-selfcheck", action="store_true")
    parser.add_argument("--scene",
                        choices=["dragon", "lambert", "refdefault"],
                        default="dragon")
    parser.add_argument("--spp", type=int, default=16)
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--traversal", choices=["kernel", "xla"],
                        default="kernel")
    args = parser.parse_args(argv)

    from metal_pathtracer.utils.compilecache import enable_cache
    enable_cache()
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py needs a GPU; JAX's default device is "
                 f"{dev.platform!r}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]

    from metal_pathtracer.renderer import frame
    from metal_pathtracer.renderer.accumulation import RenderState
    from metal_pathtracer.utils.benchscene import build_bench_scene, \
        frame_inputs

    width, height = 1920, 1080
    if args.scene == "dragon":
        settings, resources, environment = build_bench_scene(8)
        scene_name = "dragon-class-hdr-env"
    elif args.scene == "refdefault":
        # The reference's own default workload shape: 1280x720 headless
        # default resolution, maxDepth 20 (reference: main_headless.mm:39,
        # 511-515, RenderSettings.h:41-42). Same scene content.
        settings, resources, environment = build_bench_scene(8)
        settings.maxDepth = 20
        width, height = 1280, 720
        scene_name = "refdefault-720p-depth20"
    else:
        from metal_pathtracer.scene.resources import (
            Material,
            SceneResources,
        )
        from metal_pathtracer.settings import RenderSettings
        from metal_pathtracer.utils.procgen import dragon_class_scene_mesh
        settings = RenderSettings()
        settings.cameraTarget = (0.0, 0.0, 0.0)
        settings.cameraDistance = 3.2
        settings.cameraYaw = 0.4
        settings.cameraPitch = 0.25
        settings.cameraVerticalFov = 40.0
        settings.maxDepth = 8
        settings.fixedRngSeed = 1234
        resources = SceneResources()
        resources.add_material(Material(base_color=(0.7, 0.7, 0.7)))
        resources.add_mesh(dragon_class_scene_mesh(7, material=0))
        environment = None
        scene_name = "dragon-class-procedural"

    parity_ok = True if args.no_selfcheck else _selfcheck(
        settings, resources, environment)

    t0 = time.perf_counter()
    scene, static, uniforms = frame_inputs(settings, resources, environment,
                                           width, height, args.traversal)
    state = RenderState.create(width, height)
    # Warm up / compile every n_samples the timed window uses (a static
    # argument), so no compile lands inside a timed rep.
    for n in sorted({1, args.spp}):
        state = frame.render_samples(scene, uniforms, state, static, n)
        state.radiance_sum.block_until_ready()
    setup = time.perf_counter() - t0

    mrays, elapsed, rates = _median_rate(frame, scene, uniforms, state,
                                         static, args.spp, args.reps)
    result = {
        "metric": f"mrays_per_sec_{scene_name}_{width}x{height}",
        "value": round(mrays, 3),
        "unit": "Mrays/s",
        "parity_ok": parity_ok,
        "traversal": args.traversal,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card,
    }
    print(json.dumps(result))
    print(f"# {card} spp={args.spp} x{args.reps} median_elapsed="
          f"{elapsed:.3f}s spread=[{rates[0]:.3f},{rates[-1]:.3f}] Mrays/s "
          f"ms_per_sample={1e3 * elapsed / args.spp:.2f} "
          f"setup_s={setup:.1f}", file=sys.stderr)
    return 0 if parity_ok else 1


if __name__ == "__main__":
    sys.exit(main())
