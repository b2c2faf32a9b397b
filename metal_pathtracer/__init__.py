"""metal_pathtracer — a physically based progressive path tracer in JAX.

A ground-up JAX/XLA/Pallas re-design of the capabilities of
``dariopagliaricci/Metal-PathTracer-arm64`` ("Path Tracer Metal v2.0"):

- progressive accumulation path tracing with NEE/MIS, env importance
  sampling, a full BSDF zoo (lambert / GGX metal / dielectric / plastic /
  SSS / carpaint / glTF PBR metallic-roughness), and deterministic RNG,
- a wavefront (SoA) integrator instead of the reference's GPU megakernel,
  built from fixed shapes, masked lanes and a `lax.while_loop` over
  bounces, with a Pallas (Triton) kernel for BVH traversal on NVIDIA GPUs,
- multi-chip scaling via `jax.sharding.Mesh` + `shard_map` over the
  pixel/sample wavefront (the reference is single-GPU; see parallel/mesh.py),
- grammar-compatible `.scene` DSL, flag-compatible headless CLI, and
  EXR/PNG/PFM/PPM output.

Reference layer map: /root/reference (see SURVEY.md). This package is a new
implementation — no code is copied from the reference; behavioral citations
(file:line) are given in docstrings so parity can be audited.
"""

__version__ = "0.1.0"

from metal_pathtracer.settings import (  # noqa: F401
    BackgroundMode,
    RenderSettings,
    SssMode,
    WorkingColorSpace,
)
