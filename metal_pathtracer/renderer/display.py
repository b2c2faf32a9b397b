"""Display path: exposure -> bloom -> tonemap -> gamma.

The jnp twin of the reference's fullscreen display pass
(reference: shaders/display.metal:1-149): exposure scaling, the 9-tap
threshold bloom (:56-105), then the selected tonemap curve and gamma 2.2.
Also reused by the PNG writer path so saved LDR images match the display.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from metal_pathtracer.ops import tonemap as tonemap_ops
from metal_pathtracer.ops.denoise import denoise_state


def display_image(state, settings, use_denoised: bool = None) -> jnp.ndarray:
    """RenderState -> LDR (H,W,3) in [0,1] following the display shader."""
    if use_denoised is None:
        use_denoised = settings.denoiseEnabled
    if use_denoised:
        hdr = denoise_state(state, settings)
    else:
        hdr = state.present()

    hdr = hdr * jnp.exp2(jnp.float32(settings.exposure))
    if settings.bloomEnabled:
        hdr = tonemap_ops.bloom(hdr, settings.bloomThreshold,
                                settings.bloomIntensity, settings.bloomRadius)
    # curve + gamma (exposure already applied -> pass exposure=0)
    return tonemap_ops.apply_tonemap(hdr, settings.tonemapMode,
                                     settings.acesVariant, 0.0,
                                     settings.reinhardWhitePoint)


def display_to_u8(state, settings) -> np.ndarray:
    ldr = np.asarray(display_image(state, settings))
    return np.clip(np.floor(ldr * 255.0 + 0.5), 0, 255).astype(np.uint8)
