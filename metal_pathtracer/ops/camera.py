"""RTOW-style orbit camera.

Pure function building the camera basis from RenderSettings, numerically
matching the reference's uniform builder
(reference: src/renderer/UniformBuilder.mm:34-83) and the per-pixel primary
ray generation (reference: shaders/pathtrace.metal:9742-9752).
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np

from metal_pathtracer.ops import rng as rng_ops
from metal_pathtracer.schema import CameraUniforms


def build_camera(settings, width: int, height: int,
                 to_device: bool = True) -> CameraUniforms:
    """Settings -> camera basis. Host-side (numpy), result goes to device
    unless ``to_device=False`` (pure-numpy consumers like the CPU oracle
    must never trigger device transfers)."""
    aspect = float(width) / float(height)
    vfov = min(max(settings.cameraVerticalFov, 1.0), 179.0)
    defocus_angle = max(settings.cameraDefocusAngle, 0.0)

    theta = math.radians(vfov)
    h = math.tan(theta * 0.5)
    viewport_height = 2.0 * h
    viewport_width = aspect * viewport_height

    distance = max(settings.cameraDistance, 0.1)
    yaw = settings.cameraYaw
    pitch = settings.cameraPitch
    offset = np.array([
        distance * math.cos(pitch) * math.cos(yaw),
        distance * math.sin(pitch),
        distance * math.cos(pitch) * math.sin(yaw),
    ], np.float32)

    look_at = np.asarray(settings.cameraTarget, np.float32)
    look_from = look_at + offset
    vup = np.array([0.0, 1.0, 0.0], np.float32)

    w = look_from - look_at
    w = w / np.linalg.norm(w)
    u = np.cross(vup, w)
    u = u / np.linalg.norm(u)
    v = np.cross(w, u)

    focus_dist = settings.cameraFocusDistance
    if focus_dist <= 0.0:
        focus_dist = distance

    horizontal = (focus_dist * viewport_width) * u
    vertical = (focus_dist * viewport_height) * v
    lower_left = look_from - 0.5 * horizontal - 0.5 * vertical - focus_dist * w
    lens_radius = focus_dist * math.tan(math.radians(defocus_angle * 0.5))

    if to_device:
        f = lambda a: jnp.asarray(np.asarray(a, np.float32))
        lr = jnp.float32(lens_radius)
    else:
        f = lambda a: np.asarray(a, np.float32)
        lr = np.float32(lens_radius)
    return CameraUniforms(
        origin=f(look_from),
        lower_left=f(lower_left),
        horizontal=f(horizontal),
        vertical=f(vertical),
        u=f(u),
        v=f(v),
        lens_radius=lr,
    )


def generate_primary_rays(camera: CameraUniforms, x, y, width, height, state):
    """Jittered primary rays for integer pixel coords x, y (any shape).

    Matches the kernel entry exactly, including the v-flip and the
    unnormalized direction `pixel - origin` — intersection t is measured in
    units of that direction's length, as in the reference
    (reference: pathtrace.metal:9742-9752).

    Returns (state, origin, direction).
    """
    state, jx = rng_ops.rand_uniform(state)
    u = (x.astype(jnp.float32) + jx) / jnp.float32(width)
    state, jy = rng_ops.rand_uniform(state)
    v = (y.astype(jnp.float32) + jy) / jnp.float32(height)
    v = 1.0 - v

    pixel = (camera.lower_left
             + u[..., None] * camera.horizontal
             + v[..., None] * camera.vertical)
    state, disk = rng_ops.random_in_unit_disk(state)
    disk = camera.lens_radius * disk
    offset = disk[..., 0:1] * camera.u + disk[..., 1:2] * camera.v
    origin = camera.origin + offset
    direction = pixel - origin
    return state, origin, direction
