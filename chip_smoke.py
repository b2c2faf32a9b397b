#!/usr/bin/env python
"""Smoke run of the path tracer on one NVIDIA GPU, through its entry points.

    python chip_smoke.py            # phases 1-5 on one card
    python chip_smoke.py --four     # phase 6 only: one frame over four cards

Phases (each failure exits non-zero; nothing is caught):

1. device   the platform is "gpu"; card name and power limit, versions
2. kernel   the traversal kernel compiled for one integrator chunk
            (frame.DEFAULT_CHUNK lanes) against the headline BVH, compared
            with the plain-XLA traversal on camera rays and one bounce
            generation (utils/routecheck.py tolerances), both timed
3. frame    JaxBackend.render of the headline scene at 1920x1080,
            maxDepth 8, 4 spp after one warm-up call
4. parity   smoke, cornell and the headline scene at 3 subdivisions,
            64x64x16 spp on the card vs CPU-JAX in this process, and vs the
            native C++ oracle at tests/test_oracle_parity.py's gates
5. tests    the `gpu`-marked tests, run in this process (pytest.main)
6. --four   the headline frame, 1920x1080 at 2 spp, through
            parallel/mesh.py over four cards vs one card

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

# the on-card tests of phase 5 must see the GPU (tests/conftest.py)
os.environ["MPT_TESTS_ON_DEVICE"] = "1"
ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

from metal_pathtracer.utils.compilecache import enable_cache  # noqa: E402

#: linear-HDR RMSE bound between the card's and CPU-JAX's images: the
#: same integrator and RNG streams, but transcendentals and FMA
#: contraction differ in the last bits, and a lane that flips a branch
#: takes another path; see PERF.md
GPU_CPU_RMSE = 1e-3
#: per-scene oracle gates of tests/test_oracle_parity.py (RMSE, mean
#: diff): its smoke and cornell gates, and its env-lit scene gate for the
#: headline
ORACLE_GATES = {"smoke": (0.01, None), "cornell": (0.02, 0.005),
                "headline-s3": (0.06, 0.02)}

CARD = "unknown card"
#: the headline frame (width, height, maxDepth from the scene)
FRAME = (1920, 1080)


def say(name: str, value) -> None:
    """One measurement line, tagged with the card it was taken on."""
    print(f"{name}: {value}  [{CARD}]", flush=True)


def fail(msg: str):
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


# ---------------------------------------------------------------------------


def phase_device(expect: int):
    global CARD
    import jax
    import jaxlib

    devs = jax.devices()
    check(devs[0].platform == "gpu",
          f"JAX found no GPU (platform {devs[0].platform!r})")
    check(len(devs) >= expect, f"need {expect} GPUs, found {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    print(smi[0], flush=True)
    CARD = smi[0]
    print(f"device_kind: {devs[0].device_kind}  count: {len(devs)}")
    print(f"jax {jax.__version__}  jaxlib {jaxlib.__version__}")
    print(f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    print(f"compile cache: {enable_cache()}", flush=True)
    return devs


def headline(subdivisions: int = 8):
    from metal_pathtracer.utils.benchscene import build_bench_scene
    return build_bench_scene(subdivisions)


def phase_kernel():
    import jax

    from metal_pathtracer.constants import EPSILON_T, INFINITY_T
    from metal_pathtracer.ops import traversal
    from metal_pathtracer.renderer.frame import DEFAULT_CHUNK
    from metal_pathtracer.utils import routecheck

    settings, res, env = headline()
    t0 = time.perf_counter()
    scene = res.build_arrays(environment=env, traversal="kernel")
    jax.block_until_ready(scene)
    say("headline scene + BVH build s", time.perf_counter() - t0)
    say("bvh nodes", scene.tri_bvh.node_count)
    say("triangles", scene.triangles.count)

    lanes = DEFAULT_CHUNK
    o, d = routecheck.chunk_rays(settings, *FRAME, lanes)
    o2, d2, tmax2, exm, exp = routecheck.bounce_rays(scene, o, d)
    tmax1 = np.full((lanes,), INFINITY_T, np.float32)

    lowered = jax.jit(lambda o_, d_, t_: traversal.trace_best(
        o_, d_, scene.triangles, scene.tri_bvh, scene.tri_kernel,
        EPSILON_T, t_)).lower(o, d, tmax1)
    compiled = lowered.compile()
    print(f"kernel memory_analysis: {compiled.memory_analysis()}")

    for name, args in (("primary", (o, d, EPSILON_T, tmax1, None, None)),
                       ("bounce", (o2, d2, EPSILON_T, tmax2, exm, exp))):
        r = routecheck.compare(scene, *args)
        say(f"route check {name}", json.dumps(r))
        check(r["ok"], f"kernel vs XLA traversal disagrees on {name} rays")

        def run(tables, any_hit=False):
            fn = jax.jit(lambda *a: traversal.trace_best(
                a[0], a[1], scene.triangles, scene.tri_bvh, tables, *a[2:],
                any_hit=any_hit))
            return lambda: jax.block_until_ready(fn(*args))
        tk = routecheck.time_call(run(scene.tri_kernel))
        tx = routecheck.time_call(run(None))
        ta = routecheck.time_call(run(scene.tri_kernel, True))
        say(f"{name} {lanes}-lane trace ms: kernel / xla / kernel any-hit",
            f"{1e3 * tk:.3f} / {1e3 * tx:.3f} / {1e3 * ta:.3f}")
    say("kernel block lanes", scene.tri_kernel.block)


def phase_frame():
    import jax

    from metal_pathtracer.renderer.headless import JaxBackend

    settings, res, env = headline()
    backend = JaxBackend()
    w, h = FRAME
    t0 = time.perf_counter()
    out = _render(backend, settings, res, env, w, h, 4)
    first = time.perf_counter() - t0
    out = _render(backend, settings, res, env, w, h, 4)
    img = out.linear_rgb
    check(img.shape[:2] == (h, w), f"image shape {img.shape}")
    check(bool(np.isfinite(img).all()), "non-finite pixels")
    check(bool((out.sample_count == 4).all()), "sample counts != 4")
    check(out.rays > 0 and out.shadow_rays > 0, "ray counters are zero")
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    say(f"frame {w}x{h} depth {settings.maxDepth} ms/sample",
        out.avg_ms_per_sample)
    say("frame Mrays/s (closest + shadow)",
        (out.rays + out.shadow_rays) / out.total_seconds / 1e6)
    say("frame rays / shadow rays per sample",
        f"{out.rays / 4:.0f} / {out.shadow_rays / 4:.0f}")
    say("frame setup s (scene + BVH build + first compile)",
        first - out.total_seconds)
    say("frame peak device bytes", peak)
    say("frame mean radiance", float(img.mean()))


def _render(backend, settings, res, env, w, h, spp):
    return backend.render(res, settings, w, h, spp, environment=env)


def _scene_file(name):
    """A scene file loaded the way cli.py loads it."""
    from metal_pathtracer.scene.manager import SceneManager
    from metal_pathtracer.settings import RenderSettings

    manager = SceneManager()
    settings, res = RenderSettings(), manager.new_resources()
    manager.load_scene_from_path(
        os.path.join(ROOT, "assets", "scenes", f"{name}.scene"), settings,
        res)
    return settings, res, None


def phase_parity():
    from metal_pathtracer.renderer import oracle
    from metal_pathtracer.renderer.headless import CpuJaxBackend, JaxBackend

    check(oracle.oracle_available(), "native oracle did not build")
    w = h = 64
    spp = 16
    scenes = {"smoke": lambda: _scene_file("smoke"),
              "cornell": lambda: _scene_file("cornell"),
              "headline-s3": lambda: headline(3)}
    failures = []
    for name, make in scenes.items():
        settings, res, env = make()
        gpu = _render(JaxBackend(), settings, res, env, w, h, spp).linear_rgb
        cpu = _render(CpuJaxBackend(), settings, res, env, w, h,
                      spp).linear_rgb
        ref = oracle.render_oracle(res, settings, w, h, spp,
                                   environment=env)
        e_cpu = oracle.rmse(gpu, cpu)
        e_ora = oracle.rmse(gpu, ref)
        gate, mean_gate = ORACLE_GATES[name]
        say(f"parity {name} 64x64x16: rmse gpu-vs-cpu / gpu-vs-oracle "
            f"(gates {GPU_CPU_RMSE} / {gate}); means gpu / cpu / oracle",
            f"{e_cpu:.3e} / {e_ora:.3e}; {gpu.mean():.5f} / "
            f"{cpu.mean():.5f} / {ref.mean():.5f}")
        if not np.isfinite(gpu).all():
            failures.append(f"{name}: non-finite pixels")
        if not e_cpu < GPU_CPU_RMSE:
            failures.append(f"{name}: GPU vs CPU-JAX rmse {e_cpu}")
        if not e_ora < gate:
            failures.append(f"{name}: GPU vs oracle rmse {e_ora}")
        if mean_gate is not None \
                and not abs(gpu.mean() - ref.mean()) < mean_gate:
            failures.append(f"{name}: GPU vs oracle mean")
    check(not failures, "; ".join(failures))


def phase_tests():
    import pytest

    rc = pytest.main([os.path.join(ROOT, "tests"), "-q", "-m", "gpu",
                      "-p", "no:cacheprovider", "-p", "no:xdist",
                      "-p", "no:randomly"])
    check(rc == 0, f"gpu-marked tests failed (pytest exit {rc})")


def phase_four():
    """The headline frame over four cards (parallel/mesh.py) vs one card."""
    import jax

    from metal_pathtracer.parallel import mesh as mesh_ops
    from metal_pathtracer.renderer.accumulation import RenderState
    from metal_pathtracer.renderer.frame import render_samples
    from metal_pathtracer.utils.benchscene import frame_inputs

    (w, h), spp = FRAME, 2
    scene, static, uni = frame_inputs(*headline(), w, h)
    mesh = mesh_ops.make_mesh(jax.devices()[:4])
    scene4 = mesh_ops.replicate(scene, mesh)
    uni4 = mesh_ops.replicate(uni, mesh)

    def four():
        st = mesh_ops.shard_state(RenderState.create(w, h), mesh)
        out = mesh_ops.render_samples_sharded(scene4, uni4, st, static, spp,
                                              mesh)
        return jax.block_until_ready(out)

    def one():
        out = render_samples(scene, uni, RenderState.create(w, h), static,
                             spp)
        return jax.block_until_ready(out)

    times = {}
    for name, fn in (("4 cards", four), ("1 card", one)):
        t0 = time.perf_counter()
        out = fn()
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = fn()
        times[name] = time.perf_counter() - t0
        say(f"--four {name} {w}x{h}x{spp}: first call s / call s",
            f"{first:.3f} / {times[name]:.3f}")
        if name == "4 cards":
            sharded = np.asarray(mesh_ops.unpad_state(out, h).radiance_sum)
        else:
            single = np.asarray(out.radiance_sum)
    diff = np.abs(sharded - single)
    say("--four max |4-card - 1-card| radiance_sum", float(diff.max()))
    say("--four pixels outside rtol/atol 2e-4",
        int((diff > 2e-4 + 2e-4 * np.abs(single)).sum()))
    say("--four speedup (1 card / 4 cards)",
        times["1 card"] / times["4 cards"])
    np.testing.assert_allclose(sharded, single, rtol=2e-4, atol=2e-4)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--four", action="store_true",
                   help="run only the four-card phase")
    p.add_argument("--phases", default="device,kernel,frame,parity,tests",
                   help="comma-separated subset of the one-card phases")
    args = p.parse_args(argv)

    devs = phase_device(4 if args.four else 1)
    if args.four:
        phase_four()
    else:
        phases = {"kernel": phase_kernel, "frame": phase_frame,
                  "parity": phase_parity, "tests": phase_tests}
        for name in args.phases.split(","):
            if name != "device":
                t0 = time.perf_counter()
                phases[name]()
                say(f"phase {name} wall s", time.perf_counter() - t0)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
