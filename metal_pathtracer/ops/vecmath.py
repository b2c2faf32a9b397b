"""Vector math helpers over trailing-dim-3 arrays.

Everything operates elementwise over arbitrary leading (wavefront) dims so
the integrator stays fully vectorized.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from metal_pathtracer.constants import LUMINANCE_WEIGHTS


def dot(a, b):
    return jnp.sum(a * b, axis=-1)


def dot3(a, b, keepdims=False):
    return jnp.sum(a * b, axis=-1, keepdims=keepdims)


def length(v):
    return jnp.sqrt(jnp.maximum(dot(v, v), 0.0))


def normalize(v, eps=0.0):
    return v / jnp.sqrt(jnp.maximum(dot3(v, v, keepdims=True), 1e-38))


def safe_normalize(v):
    """Normalize; zero-length vectors come back unchanged-safe (no NaN)."""
    len2 = dot3(v, v, keepdims=True)
    inv = jnp.where(len2 > 0.0, 1.0 / jnp.sqrt(jnp.maximum(len2, 1e-38)), 0.0)
    return v * inv


def cross(a, b):
    return jnp.cross(a, b)


def reflect(v, n):
    """Mirror v about n (Metal `reflect` semantics: v points toward surface)."""
    return v - 2.0 * dot3(v, n, keepdims=True) * n


def refract(v, n, eta_ratio):
    """Metal/GLSL `refract`: returns 0-vector on total internal reflection.

    v must be unit incident direction (pointing toward the surface), n unit
    normal against v; eta_ratio = etaI/etaT.
    """
    cos_i = -dot3(v, n, keepdims=True)
    sin2_t = eta_ratio * eta_ratio * jnp.maximum(1.0 - cos_i * cos_i, 0.0)
    k = 1.0 - sin2_t
    refr = eta_ratio * v + (eta_ratio * cos_i - jnp.sqrt(jnp.maximum(k, 0.0))) * n
    return jnp.where(k >= 0.0, refr, jnp.zeros_like(v))


def luminance(rgb):
    w = jnp.asarray(LUMINANCE_WEIGHTS, rgb.dtype)
    return dot(rgb, w)


def mix(a, b, t):
    return a + (b - a) * t


def build_onb(normal):
    """Orthonormal basis from a unit normal.

    Same construction as the reference so sampled directions match bit-wise
    (reference: shaders/pathtrace.metal build_onb).
    """
    nz = jnp.abs(normal[..., 2:3]) < 0.999
    up = jnp.where(nz,
                   jnp.asarray([0.0, 0.0, 1.0], normal.dtype),
                   jnp.asarray([1.0, 0.0, 0.0], normal.dtype))
    tangent = normalize(jnp.cross(up, normal))
    bitangent = jnp.cross(normal, tangent)
    return tangent, bitangent


def to_world(local, normal):
    """Rotate a tangent-space vector into the frame of `normal`
    (reference: pathtrace.metal to_world)."""
    tangent, bitangent = build_onb(normal)
    return (local[..., 0:1] * tangent
            + local[..., 1:2] * bitangent
            + local[..., 2:3] * normal)


def all_finite(v, axis=-1):
    return jnp.all(jnp.isfinite(v), axis=axis)


def where3(mask, a, b):
    """Select with a scalar-per-lane mask over (...,3) vectors."""
    return jnp.where(mask[..., None], a, b)


def linear_srgb_to_acescg(color):
    """3x3 linear sRGB -> ACEScg (reference: pathtrace.metal:93-99)."""
    m = jnp.asarray(
        [[0.613097, 0.339523, 0.047380],
         [0.070194, 0.916354, 0.013452],
         [0.020615, 0.109569, 0.869816]], color.dtype)
    return jnp.einsum("ij,...j->...i", m, color,
                      precision=jax.lax.Precision.HIGHEST)
