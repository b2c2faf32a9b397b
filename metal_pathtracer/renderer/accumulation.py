"""Progressive accumulation state.

The reference keeps six GPU textures + frame/sample counters
(reference: src/renderer/Accumulation.mm:20-157). Here the whole render
state is one pytree so `render_samples` is a pure jitted
`state -> state` step, and checkpoint/resume (which the reference lacks,
SURVEY.md §5.4) is a free `orbax`/npz save of this pytree.
"""

from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np

from metal_pathtracer.utils import pytree


class CheckpointError(RuntimeError):
    """A render-state checkpoint could not be read."""


@pytree.dataclass
class RenderState:
    radiance_sum: jnp.ndarray   # (H,W,3) f32 — running radiance sum
    sample_count: jnp.ndarray   # (H,W)   u32 — per-pixel sample counts
    albedo: jnp.ndarray         # (H,W,3) f32 — first-hit albedo AOV
    normal: jnp.ndarray         # (H,W,3) f32 — first-hit shading normal AOV
    frame_index: jnp.ndarray    # ()      u32 — dispatch counter
    denoised: jnp.ndarray = None  # (H,W,3) f32 or None
    # Perf counters (the analogue of the reference's PathtraceStats buffer,
    # reference: include/MetalShaderTypes.h PathtraceStats / RenderLoop.mm:511-513)
    ray_count: jnp.ndarray = None        # () f32 — scene traces issued
    shadow_ray_count: jnp.ndarray = None  # () f32 — shadow traces issued
    # Second radiance moment for the SVGF-style variance-guided denoiser
    # (the reference's OIDN has no analogue input; tracked per pixel so
    # the filter can scale its color sigma by real sample variance).
    radiance_sq_sum: jnp.ndarray = None  # (H,W,3) f32 — sum of sample^2

    @classmethod
    def create(cls, width: int, height: int) -> "RenderState":
        return cls(
            radiance_sum=jnp.zeros((height, width, 3), jnp.float32),
            sample_count=jnp.zeros((height, width), jnp.uint32),
            albedo=jnp.zeros((height, width, 3), jnp.float32),
            normal=jnp.zeros((height, width, 3), jnp.float32),
            frame_index=jnp.uint32(0),
            denoised=jnp.zeros((height, width, 3), jnp.float32),
            ray_count=jnp.float32(0.0),
            shadow_ray_count=jnp.float32(0.0),
            radiance_sq_sum=jnp.zeros((height, width, 3), jnp.float32),
        )

    @property
    def height(self) -> int:
        return self.radiance_sum.shape[0]

    @property
    def width(self) -> int:
        return self.radiance_sum.shape[1]

    def present(self) -> jnp.ndarray:
        """Average image (reference: pathtracePresentKernel,
        pathtrace.metal:9947-9961): sum / count, count==0 -> black."""
        count = jnp.maximum(self.sample_count.astype(jnp.float32), 1.0)
        avg = self.radiance_sum / count[..., None]
        return jnp.where((self.sample_count > 0)[..., None], avg, 0.0)

    def variance_of_mean(self) -> jnp.ndarray:
        """Per-pixel per-channel variance of the accumulated mean:
        max(E[x^2] - E[x]^2, 0) / n. Zero where moments are unavailable
        (n < 2, or resume from a pre-sq_sum checkpoint)."""
        if self.radiance_sq_sum is None:
            return jnp.zeros_like(self.radiance_sum)
        n = jnp.maximum(self.sample_count.astype(jnp.float32), 1.0)[..., None]
        mean = self.radiance_sum / n
        var = jnp.maximum(self.radiance_sq_sum / n - mean * mean, 0.0) / n
        return jnp.where((self.sample_count > 1)[..., None], var, 0.0)

    def save(self, path: str, digest: str = "") -> None:
        """Checkpoint to .npz — resume is `RenderState.load(path)`.

        `digest` identifies the (scene, settings) the accumulation belongs
        to; `load` refuses to resume under a different digest so unrelated
        accumulations can never be silently blended (ADVICE r01).
        """
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        # write through a handle so np.savez can't append ".npz" and break
        # the exists() check on resume
        with open(path, "wb") as fh:
            np.savez(
                fh,
                digest=np.asarray(digest),
                radiance_sum=np.asarray(self.radiance_sum),
                sample_count=np.asarray(self.sample_count),
                albedo=np.asarray(self.albedo),
                normal=np.asarray(self.normal),
                frame_index=np.asarray(self.frame_index),
                denoised=np.asarray(self.denoised),
                ray_count=np.asarray(
                    self.ray_count if self.ray_count is not None else 0.0),
                shadow_ray_count=np.asarray(
                    self.shadow_ray_count
                    if self.shadow_ray_count is not None else 0.0),
                radiance_sq_sum=np.asarray(
                    self.radiance_sq_sum
                    if self.radiance_sq_sum is not None
                    else np.zeros_like(np.asarray(self.radiance_sum))),
            )

    @classmethod
    def load(cls, path: str, expect_digest: str = None,
             expect_size: tuple = None) -> "RenderState":
        """Load a checkpoint; validates resolution and scene/settings digest.

        expect_size is (width, height); expect_digest the digest the caller
        would save with today. Either mismatch raises CheckpointError
        instead of silently resuming the wrong accumulation (ADVICE r01).
        """
        try:
            data = np.load(path)
            data["radiance_sum"]  # force header validation
        except Exception as exc:
            raise CheckpointError(
                f"could not load render-state checkpoint {path!r}: {exc}"
            ) from exc
        h, w = data["radiance_sum"].shape[:2]
        if expect_size is not None and (w, h) != tuple(expect_size):
            raise CheckpointError(
                f"checkpoint {path!r} is {w}x{h} but this render is "
                f"{expect_size[0]}x{expect_size[1]}; delete the checkpoint "
                "or match the resolution")
        if expect_digest:
            stored = str(data["digest"]) if "digest" in data else ""
            if stored and stored != expect_digest:
                raise CheckpointError(
                    f"checkpoint {path!r} was rendered with a different "
                    "scene/settings (digest mismatch); delete it to start "
                    "fresh")
        return cls(
            radiance_sum=jnp.asarray(data["radiance_sum"]),
            sample_count=jnp.asarray(data["sample_count"]),
            albedo=jnp.asarray(data["albedo"]),
            normal=jnp.asarray(data["normal"]),
            frame_index=jnp.asarray(data["frame_index"]),
            denoised=jnp.asarray(data["denoised"]) if "denoised" in data else None,
            ray_count=jnp.asarray(data["ray_count"]) if "ray_count" in data
            else jnp.float32(0.0),
            shadow_ray_count=jnp.asarray(data["shadow_ray_count"])
            if "shadow_ray_count" in data else jnp.float32(0.0),
            radiance_sq_sum=jnp.asarray(data["radiance_sq_sum"])
            if "radiance_sq_sum" in data else None,
        )
