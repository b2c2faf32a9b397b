"""Performance stats + structured logging.

The analogue of the reference's `PerformanceStats` struct and its ImGui
Performance panel / `--verbose` timing logs
(reference: include/renderer/PerformanceStats.h:12-114,
src/MetalRenderer.mm:958-981 for the rolling averages and samples/min,
src/MetalRenderer.mm:1144-1347 for the per-ray derived counters).

There is no atomic stats buffer; per-ray counters are carried as a
summed metrics pytree alongside the wavefront (psum across chips,
SURVEY.md §5.1) and land in `RenderState.ray_count / shadow_ray_count`.
Wall-clock timing is host-side around blocking `block_until_ready()`
boundaries, which is the moral equivalent of the reference's command-buffer
GPUStartTime/GPUEndTime readback (MetalRenderer.mm:1154-1159).

Logging mirrors the reference's bracketed-tag console style
(`[Timing]`, `[Output]`, `[Renderer]` — SURVEY.md §5.5) on top of the
standard `logging` module so levels/handlers compose with host tooling.
"""

from __future__ import annotations

import dataclasses
import logging
import sys
import time
from typing import Optional

# ---------------------------------------------------------------------------
# Structured logging with the reference's bracketed-tag style
# ---------------------------------------------------------------------------

_FORMATTER = logging.Formatter("[%(tag)s] %(message)s")
_ROOT_NAME = "metal_pathtracer"


class _TagAdapter(logging.LoggerAdapter):
    """Injects the `[Tag]` prefix the reference uses for every subsystem."""

    def process(self, msg, kwargs):
        extra = kwargs.setdefault("extra", {})
        extra.setdefault("tag", self.extra["tag"])
        return msg, kwargs


class _DynamicStdout:
    """Late-binding stdout so redirection (pytest capture, piping into a
    file after setup) is honored."""

    def write(self, s):
        sys.stdout.write(s)

    def flush(self):
        sys.stdout.flush()


def get_logger(tag: str = "Renderer") -> logging.LoggerAdapter:
    """`get_logger("Timing").info(...)` prints `[Timing] ...`."""
    base = logging.getLogger(_ROOT_NAME)
    if not base.handlers:
        handler = logging.StreamHandler(_DynamicStdout())
        handler.setFormatter(_FORMATTER)
        base.addHandler(handler)
        base.setLevel(logging.INFO)
        base.propagate = False
    return _TagAdapter(base, {"tag": tag})


def set_verbose(verbose: bool) -> None:
    """--verbose maps to DEBUG, default INFO (the reference has exactly the
    two levels: always-on bracketed logs + --verbose one-shot timings)."""
    logging.getLogger(_ROOT_NAME).setLevel(
        logging.DEBUG if verbose else logging.INFO)


# ---------------------------------------------------------------------------
# PerformanceStats
# ---------------------------------------------------------------------------

def _ema(prev: float, value: float, alpha: float = 0.1) -> float:
    """Rolling average with the reference's low-pass style
    (MetalRenderer.mm:958-981 keeps smoothed ms metrics)."""
    return value if prev == 0.0 else (1.0 - alpha) * prev + alpha * value


@dataclasses.dataclass
class PerformanceStats:
    """Rolling render metrics (reference: PerformanceStats.h:12-114).

    Device-side counters arrive via `update(...)` from the metrics the
    integrator sums (RenderState.ray_count / shadow_ray_count); host-side
    timing comes from the sample-batch wall clock.
    """

    # timing (reference fields: gpuTimeMs, cpuEncodeTimeMs, frameTimeMs)
    device_ms_per_batch: float = 0.0
    frame_time_ms: float = 0.0
    # throughput (reference: samplesPerMinute; Mrays/s is the README's
    # headline metric, README.md:144-148)
    samples_per_minute: float = 0.0
    mrays_per_second: float = 0.0
    # totals
    total_samples: int = 0
    total_rays: float = 0.0
    total_shadow_rays: float = 0.0
    total_seconds: float = 0.0
    # per-sample derived counters (reference derives avg nodes/ray etc.,
    # MetalRenderer.mm:1168-1347; we expose the counters our wavefront sums)
    rays_per_sample: float = 0.0
    shadow_ray_fraction: float = 0.0

    def update(self, *, samples: int, seconds: float, width: int, height: int,
               ray_count: float = 0.0, shadow_ray_count: float = 0.0) -> None:
        """Fold one rendered batch into the rolling stats."""
        if samples <= 0 or seconds <= 0.0:
            return
        new_rays = max(ray_count - self.total_rays, 0.0)
        new_shadow = max(shadow_ray_count - self.total_shadow_rays, 0.0)
        self.total_samples += samples
        self.total_seconds += seconds
        self.total_rays = max(ray_count, self.total_rays)
        self.total_shadow_rays = max(shadow_ray_count, self.total_shadow_rays)

        batch_ms = 1000.0 * seconds
        self.device_ms_per_batch = _ema(self.device_ms_per_batch, batch_ms)
        self.frame_time_ms = _ema(self.frame_time_ms, batch_ms / samples)
        self.samples_per_minute = _ema(
            self.samples_per_minute, 60.0 * samples / seconds)
        traced = new_rays + new_shadow
        if traced > 0.0:
            self.mrays_per_second = _ema(
                self.mrays_per_second, traced / seconds / 1e6)
            self.rays_per_sample = traced / (samples * width * height)
            self.shadow_ray_fraction = new_shadow / traced

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    def summary(self) -> str:
        parts = [f"{self.total_samples} spp in {self.total_seconds:.2f}s",
                 f"{self.samples_per_minute:.1f} samples/min"]
        if self.mrays_per_second > 0.0:
            parts.append(f"{self.mrays_per_second:.2f} Mrays/s")
            parts.append(f"{self.rays_per_sample:.2f} rays/sample-pixel")
            parts.append(f"{100.0 * self.shadow_ray_fraction:.0f}% shadow")
        return ", ".join(parts)


class BatchTimer:
    """Wall-clock for one device batch; `with BatchTimer() as t: ...` then
    `t.seconds`. Caller is responsible for block_until_ready() inside."""

    def __enter__(self):
        self.start = time.time()
        return self

    def __exit__(self, *exc):
        self.seconds = time.time() - self.start
        return False
