"""Tonemapping and bloom post pipeline.

Numerically matches both the reference's display shader
(reference: shaders/display.metal:1-149) and its CPU writer replicas
(reference: src/renderer/ImageWriter.mm:83-162), which are identical math.
Used by the display path (device arrays, jnp) and by the PNG/PPM writers
(numpy arrays). Like the reference — which keeps CPU replicas of the
display shader precisely so the writers never touch the GPU — every
function here is array-namespace generic: numpy in, numpy math, no device
round-trip (ImageWriter.mm:83-162 vs display.metal:1-149).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from metal_pathtracer.constants import LUMINANCE_WEIGHTS


def _xp(x):
    """numpy for host arrays, jnp otherwise — writers stay off-device."""
    return np if isinstance(x, np.ndarray) else jnp


def _luminance(rgb, xp):
    return xp.sum(rgb * xp.asarray(LUMINANCE_WEIGHTS, rgb.dtype), -1)


def _apply_matrix(xp, m, c):
    """Row-major r = M.v over (..., 3); full float32 on the device (a
    default-precision contraction may run in TF32 on tensor-core GPUs)."""
    if xp is np:
        return np.einsum("ij,...j->...i", m, c)
    import jax
    return xp.einsum("ij,...j->...i", m, c,
                     precision=jax.lax.Precision.HIGHEST)


def aces_fitted(color):
    """Stephen Hill's ACES fit (reference: ImageWriter.mm ACESFitted:83-101)."""
    xp = _xp(color)
    # Row layout matches the reference's applyMatrix (row-major r = M.v)
    # including its transposed-vs-textbook coefficient order.
    input_mat = xp.asarray([
        [0.59719, 0.07600, 0.02840],
        [0.35458, 0.90834, 0.13383],
        [0.04823, 0.01566, 0.83777]], xp.float32)
    output_mat = xp.asarray([
        [1.60475, -0.10208, -0.00327],
        [-0.53108, 1.10813, -0.07276],
        [-0.07367, -0.00605, 1.07602]], xp.float32)
    c = _apply_matrix(xp, input_mat, color)
    a = c * (c + 0.0245786) - 0.000090537
    b = c * (0.983729 * c + 0.4329510) + 0.238081
    c = a / b
    c = _apply_matrix(xp, output_mat, c)
    return xp.clip(c, 0.0, 1.0)


def aces_simple(color):
    """Narkowicz approximation (reference: ImageWriter.mm ACESSimple)."""
    xp = _xp(color)
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    num = color * (a * color + b)
    den = color * (c * color + d) + e
    return xp.clip(num / den, 0.0, 1.0)


def reinhard(color, white_point):
    """(reference: ImageWriter.mm tonemapReinhard)"""
    xp = _xp(color)
    lum = _luminance(color, xp)
    denom = 1.0 + lum / xp.maximum(white_point, 1e-4)
    return xp.clip(color / denom[..., None], 0.0, 1.0)


def hable(color):
    """Uncharted 2 filmic (reference: ImageWriter.mm tonemapHable)."""
    xp = _xp(color)
    A, B, Cc, D, E, F, W = 0.15, 0.50, 0.10, 0.20, 0.02, 0.30, 11.2

    def curve(x):
        return ((x * (A * x + B)) + Cc * x + D) / ((x * (A * x + B)) + E * x + F) - D / F

    mapped = curve(color)
    white = ((W * (A * W + B)) + Cc * W + D) / ((W * (A * W + B)) + E * W + F) - D / F
    return xp.clip(mapped / white, 0.0, 1.0)


def apply_tonemap(linear_rgb, tonemap_mode: int, aces_variant: int,
                  exposure: float, reinhard_white: float):
    """Exposure -> curve -> gamma 2.2, matching
    (reference: ImageWriter.mm applyTonemap:140-162)."""
    xp = _xp(linear_rgb)
    color = linear_rgb * xp.exp2(xp.float32(exposure))
    if tonemap_mode == 2:
        color = aces_fitted(color) if aces_variant == 0 else aces_simple(color)
    elif tonemap_mode == 3:
        color = reinhard(color, reinhard_white)
    elif tonemap_mode == 4:
        color = hable(color)
    else:
        color = xp.clip(color, 0.0, 1.0)
    gamma = 1.0 / 2.2
    color = xp.power(xp.maximum(color, 0.0), gamma)
    return xp.clip(color, 0.0, 1.0)


def bloom(hdr, threshold: float, intensity: float, radius: float):
    """9-tap threshold bloom (reference: shaders/display.metal:56-105).

    Applied pre-tonemap on the HDR average, one ring of 8 taps at
    `radius` pixels plus the center.
    """
    xp = _xp(hdr)
    lum = _luminance(hdr, xp)
    mask = xp.maximum(lum - threshold, 0.0) / xp.maximum(lum, 1e-4)
    bright = hdr * mask[..., None]

    r = max(int(round(radius)), 1)
    acc = bright
    taps = [(-r, 0), (r, 0), (0, -r), (0, r), (-r, -r), (-r, r), (r, -r), (r, r)]
    for dy, dx in taps:
        acc = acc + xp.roll(bright, (dy, dx), axis=(0, 1))
    blurred = acc / 9.0
    return hdr + intensity * blurred
