"""Headless rendering backends.

Protocol + implementations mirroring the reference's headless layer
(reference: include/headless/IHeadlessRenderer.h:12-52,
src/headless/MetalHeadlessRenderer.mm:10-117):

- `JaxBackend` — the product path: jitted sample batches on JAX's default
  device, a GPU in production (the analogue of MetalHeadlessRenderer
  driving the Metal facade).
- `CpuJaxBackend` — the same integrator forced onto jax-CPU, only when the
  user asks for it; a smoke-level cross-check (the full independent C++
  oracle lives in native/).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np

from metal_pathtracer.ops.camera import build_camera
from metal_pathtracer.renderer import frame
from metal_pathtracer.renderer.accumulation import RenderState
from metal_pathtracer.schema import settings_to_static, settings_to_uniforms
from metal_pathtracer.settings import BackgroundMode, RenderSettings


@dataclasses.dataclass
class HeadlessRenderOutput:
    """(reference: IHeadlessRenderer.h HeadlessRenderOutput:30-40)"""

    linear_rgb: np.ndarray       # (H,W,3) f32
    width: int
    height: int
    samples: int
    total_seconds: float
    avg_ms_per_sample: float
    albedo: Optional[np.ndarray] = None
    normal: Optional[np.ndarray] = None
    sample_count: Optional[np.ndarray] = None
    rays: float = 0.0          # closest-hit scene traces issued by this run
    shadow_rays: float = 0.0   # shadow (any-hit) traces issued by this run


# Samples encoded per jitted step (the reference batches <=16 spp per
# command buffer, MetalHeadlessRenderer.mm:48).
DEFAULT_BATCH = 16


def _scene_digest(scene, static, uniforms) -> str:
    """sha256 over the static config + uniforms + scene arrays: identifies
    what a checkpointed accumulation was rendered with."""
    import hashlib

    import jax

    h = hashlib.sha256()
    h.update(repr(static).encode())
    for leaf in jax.tree_util.tree_leaves(uniforms):
        h.update(np.asarray(leaf).tobytes())
    for leaf in jax.tree_util.tree_leaves(scene):
        h.update(np.asarray(leaf).tobytes())
    return h.hexdigest()


class JaxBackend:
    """Progressive batch renderer on the default JAX device.

    `traversal` names the triangle traversal route ("kernel" or "xla");
    None takes the platform default (the kernel on a GPU)."""

    name = "gpu"

    def __init__(self, traversal: Optional[str] = None):
        self.traversal = traversal

    def render(self, resources, settings: RenderSettings, width: int, height: int,
               spp_total: int, verbose: bool = False,
               progress_interval: float = 0.5,
               batch: int = DEFAULT_BATCH,
               checkpoint_path: str = "",
               environment=None, **_kwargs) -> HeadlessRenderOutput:
        """`environment` (an EnvironmentSoA) replaces loading the map at
        settings.environmentMapPath, for procedural skies."""
        import os

        if environment is None \
                and settings.backgroundMode == BackgroundMode.ENVIRONMENT \
                and settings.environmentMapPath:
            from metal_pathtracer.ops import env as env_ops
            environment = env_ops.load_environment(settings.environmentMapPath)

        scene = resources.build_arrays(environment=environment,
                                       traversal=self.traversal)
        static = settings_to_static(settings, width, height,
                                    resources.material_types_present(),
                                    resources.texture_slots_present(),
                                    resources.texture_uses_uv1())
        camera = build_camera(settings, width, height)
        # Render-state checkpoint/resume (capability the reference lacks,
        # SURVEY.md §5.4): a checkpointed accumulation continues exactly
        # where it stopped (deterministic via the per-sample seed recipe).
        # The digest ties the checkpoint to this (scene, settings) so a
        # resume can never blend unrelated accumulations (ADVICE r01).
        digest = ""
        if checkpoint_path:
            digest = _scene_digest(scene, static,
                                   settings_to_uniforms(settings, camera, 0, 0))
        if checkpoint_path and os.path.exists(checkpoint_path):
            state = RenderState.load(checkpoint_path, expect_digest=digest,
                                     expect_size=(width, height))
            if verbose:
                done0 = int(np.asarray(state.frame_index))
                print(f"[Headless] resumed {done0} spp from {checkpoint_path}")
        else:
            state = RenderState.create(width, height)

        from metal_pathtracer.utils import stats as stats_mod

        perf = stats_mod.PerformanceStats()
        # counters restored from a checkpoint are history, not this run's work
        rays0 = float(np.asarray(state.ray_count))
        shadow0 = float(np.asarray(state.shadow_ray_count))
        perf.total_rays, perf.total_shadow_rays = rays0, shadow0
        log = stats_mod.get_logger("Headless")
        stats_mod.set_verbose(verbose)

        start = time.time()
        last_report = start
        last_ckpt = start
        done = int(np.asarray(state.frame_index))
        while done < spp_total:
            n = min(batch, spp_total - done)
            uniforms = settings_to_uniforms(settings, camera, 0, 0)
            with stats_mod.BatchTimer() as bt:
                state = frame.render_samples(scene, uniforms, state, static, n)
                if verbose:
                    state.radiance_sum.block_until_ready()
            done += n
            # Periodic saves so an interrupted run resumes from the last
            # completed batch, not from nothing (ADVICE r01).
            if checkpoint_path and done < spp_total \
                    and time.time() - last_ckpt >= 30.0:
                state.save(checkpoint_path, digest=digest)
                last_ckpt = time.time()
            if verbose:
                perf.update(
                    samples=n, seconds=bt.seconds, width=width, height=height,
                    ray_count=float(np.asarray(state.ray_count)),
                    shadow_ray_count=float(np.asarray(state.shadow_ray_count)))
                now = time.time()
                if now - last_report >= progress_interval or done >= spp_total:
                    log.info(f"{done}/{spp_total} spp — {perf.summary()}")
                    last_report = now

        state.radiance_sum.block_until_ready()
        total = time.time() - start
        self.last_stats = perf
        if checkpoint_path:
            state.save(checkpoint_path, digest=digest)
        img = np.asarray(state.present())
        return HeadlessRenderOutput(
            linear_rgb=img, width=width, height=height, samples=done,
            total_seconds=total,
            avg_ms_per_sample=1000.0 * total / max(done, 1),
            albedo=np.asarray(state.albedo),
            normal=np.asarray(state.normal * 0.5 + 0.5),
            sample_count=np.asarray(state.sample_count),
            rays=float(np.asarray(state.ray_count)) - rays0,
            shadow_rays=float(np.asarray(state.shadow_ray_count)) - shadow0,
        )


class CpuJaxBackend(JaxBackend):
    """Same integrator pinned to jax-CPU — a quick cross-device check."""

    name = "cpu-jax"

    def render(self, *args, **kwargs):
        import jax

        cpu = jax.devices("cpu")[0]
        with jax.default_device(cpu):
            return super().render(*args, **kwargs)


class OracleBackend:
    """The native C++ CPU oracle — the parity reference backend, playing
    the reference's `--backend=embree` role
    (reference: src/headless/EmbreeHeadlessRenderer.mm)."""

    name = "oracle"

    def render(self, resources, settings: RenderSettings, width: int,
               height: int, spp_total: int, verbose: bool = False,
               n_threads: int = 0, **_kwargs) -> HeadlessRenderOutput:
        from metal_pathtracer.renderer import oracle

        if _kwargs.get("checkpoint_path"):
            print("[Oracle] warning: --checkpoint is not supported by the "
                  "CPU oracle backend; rendering from scratch")

        environment = None
        if settings.backgroundMode == BackgroundMode.ENVIRONMENT \
                and settings.environmentMapPath:
            from metal_pathtracer.ops import env as env_ops
            environment = env_ops.load_environment(settings.environmentMapPath,
                                                   to_device=False)

        start = time.time()
        img = oracle.render_oracle(resources, settings, width, height,
                                   spp_total, environment=environment,
                                   n_threads=n_threads)
        total = time.time() - start
        if verbose:
            print(f"[Oracle] {spp_total} spp in {total:.1f}s")
        return HeadlessRenderOutput(
            linear_rgb=img, width=width, height=height, samples=spp_total,
            total_seconds=total,
            avg_ms_per_sample=1000.0 * total / max(spp_total, 1))


def make_backend(name: str):
    """(reference: main_headless.mm --backend=metal|embree)

    "gpu" (and the reference's "metal") renders on JAX's default device and
    does not catch a failure to bring that device up: an accelerator that
    cannot start is an error, never a quiet CPU render. It renders on the
    CPU only when JAX_PLATFORMS asks for it."""
    if name in ("gpu", "metal"):  # accept the reference's flag value
        import os

        import jax
        platform = jax.devices()[0].platform
        asked = os.environ.get("JAX_PLATFORMS", "").split(",")
        if platform != "gpu" and platform not in asked:
            raise RuntimeError(
                f"no GPU: JAX's default device is {platform!r}; ask for "
                "the CPU with --backend=cpu-jax or JAX_PLATFORMS=cpu")
        return JaxBackend()
    if name in ("cpu", "oracle", "embree"):
        from metal_pathtracer.renderer import oracle
        if oracle.oracle_available():
            return OracleBackend()
        # Never silently swap renderers under the user: the oracle is the
        # parity reference; the jax-CPU path is not it.
        import sys
        print(f"[Headless] warning: backend {name!r} requested but the "
              "native CPU oracle is unavailable (build it with "
              "native/build.sh); falling back to the jax-CPU backend",
              file=sys.stderr)
        return CpuJaxBackend()
    if name == "cpu-jax":
        return CpuJaxBackend()
    raise ValueError(f"unknown backend: {name}")
