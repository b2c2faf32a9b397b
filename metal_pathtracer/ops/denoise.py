"""Device denoise pass: edge-aware à-trous wavelet filtering.

The reference denoises through OIDN on the CPU with albedo+normal
auxiliary images and a GPU->CPU->GPU round trip every
`denoiseFrequency` frames (reference: src/renderer/DenoiserContext.mm,
RenderLoop.mm:393-447). A neural CPU denoiser would stall the device the
same way, so the on-device pass is an SVGF-style à-trous filter guided
by the same AOVs — pure stencil convolutions that XLA fuses well. The
iteration count maps to the RT filter's strength; OIDN-on-CPU remains
possible via the same AOV buffers if bit-parity with the reference's
denoiser is ever needed.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from metal_pathtracer.ops.vecmath import dot

# 5-tap B3-spline kernel for the à-trous pyramid
_KERNEL = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)


def atrous_denoise(color, albedo, normal, iterations: int = 4,
                   sigma_color: float = 0.35, sigma_normal: float = 0.25,
                   sigma_albedo: float = 0.2, sigma_color_decay: float = 3.0):
    """Edge-aware à-trous filtering of (H,W,3) radiance.

    `albedo` and `normal` are the first-hit AOVs the accumulation already
    tracks (the same auxiliary inputs the reference feeds OIDN,
    DenoiserContext.mm:316-481).

    sigma_color decays by `sigma_color_decay` per iteration: wide steps
    only smooth already-similar radiance, so late iterations can't blur
    smooth lighting gradients (measured on cornell@16spp: constant sigma
    made RMSE WORSE than the noisy input, 0.089 vs 0.057; decay 3.0 gives
    0.041 — the quality gate in tests/test_denoise_quality.py pins this).
    """
    out = color

    def tap_weight(dc, dn, da, sc):
        wc = jnp.exp(-dot(dc, dc) / (2.0 * sc ** 2))
        wn = jnp.exp(-dn / (2.0 * sigma_normal ** 2))
        wa = jnp.exp(-dot(da, da) / (2.0 * sigma_albedo ** 2))
        return wc * wn * wa

    for it in range(iterations):
        step = 1 << it
        sc = sigma_color / (sigma_color_decay ** it)
        accum = jnp.zeros_like(out)
        weight_sum = jnp.zeros(out.shape[:2], out.dtype)
        for ky, wy in zip((-2, -1, 0, 1, 2), _KERNEL):
            for kx, wx in zip((-2, -1, 0, 1, 2), _KERNEL):
                w_k = wy * wx
                shifted = jnp.roll(out, (ky * step, kx * step), axis=(0, 1))
                s_albedo = jnp.roll(albedo, (ky * step, kx * step), axis=(0, 1))
                s_normal = jnp.roll(normal, (ky * step, kx * step), axis=(0, 1))
                dn = jnp.maximum(1.0 - dot(s_normal, normal), 0.0)
                w = w_k * tap_weight(shifted - out, dn, s_albedo - albedo, sc)
                accum = accum + shifted * w[..., None]
                weight_sum = weight_sum + w
        out = accum / jnp.maximum(weight_sum, 1e-6)[..., None]
    return out


def _gauss3(img):
    """Separable 3x3 (1,2,1)/4 blur of (H,W) or (H,W,C)."""
    w = (0.25, 0.5, 0.25)
    out = sum(wk * jnp.roll(img, k, axis=0) for k, wk in zip((-1, 0, 1), w))
    return sum(wk * jnp.roll(out, k, axis=1) for k, wk in zip((-1, 0, 1), w))


def _luminance(rgb):
    return (0.2126 * rgb[..., 0] + 0.7152 * rgb[..., 1]
            + 0.0722 * rgb[..., 2])


def svgf_denoise(color, albedo, normal, variance, iterations: int = 4,
                 sigma_lum: float = 1.5, sigma_normal_pow: float = 64.0,
                 sigma_albedo: float = 0.25):
    """Variance-guided à-trous filtering (the spatial core of SVGF,
    Schied et al. 2017, without the temporal reprojection the progressive
    accumulator already provides by averaging samples in place).

    `variance` is the per-pixel per-channel variance of the accumulated
    mean (RenderState.variance_of_mean). The luminance edge weight is
    scaled by the locally smoothed standard deviation, so converged or
    low-energy regions keep their edges while noisy regions smooth
    aggressively — this is what a fixed sigma_color cannot do. Variance
    is filtered alongside color with squared weights, as in the paper.
    """
    out = color
    var = _luminance(variance)

    for it in range(iterations):
        step = 1 << it
        gvar = jnp.maximum(_gauss3(var), 0.0)
        denom = sigma_lum * jnp.sqrt(gvar) + 1e-4
        lum_p = _luminance(out)
        accum = jnp.zeros_like(out)
        var_accum = jnp.zeros_like(var)
        weight_sum = jnp.zeros(out.shape[:2], out.dtype)
        for ky, wy in zip((-2, -1, 0, 1, 2), _KERNEL):
            for kx, wx in zip((-2, -1, 0, 1, 2), _KERNEL):
                w_k = wy * wx
                shift = (ky * step, kx * step)
                s_col = jnp.roll(out, shift, axis=(0, 1))
                s_var = jnp.roll(var, shift, axis=(0, 1))
                s_alb = jnp.roll(albedo, shift, axis=(0, 1))
                s_nrm = jnp.roll(normal, shift, axis=(0, 1))
                w_l = jnp.exp(-jnp.abs(_luminance(s_col) - lum_p) / denom)
                # miss pixels carry a zero normal AOV: background-to-
                # background taps must count as matching (else the center
                # tap itself gets weight 0^p and miss pixels blow up)
                both_bg = (dot(normal, normal) < 0.5) \
                    & (dot(s_nrm, s_nrm) < 0.5)
                w_n = jnp.where(
                    both_bg, 1.0,
                    jnp.maximum(dot(s_nrm, normal), 0.0)
                    ** sigma_normal_pow)
                da = s_alb - albedo
                w_a = jnp.exp(-dot(da, da) / (2.0 * sigma_albedo ** 2))
                w = w_k * w_l * w_n * w_a
                accum = accum + s_col * w[..., None]
                var_accum = var_accum + s_var * (w * w)
                weight_sum = weight_sum + w
        out = accum / jnp.maximum(weight_sum, 1e-6)[..., None]
        var = var_accum / jnp.maximum(weight_sum, 1e-6) ** 2
    return out


def _tap_features(lum_p, gstd, normal, albedo, s_col, s_nrm, s_alb,
                  it, radius, iterations):
    """Per-tap (H,W,F) feature planes for the learned weight net."""
    both_bg = ((dot(normal, normal) < 0.5)
               & (dot(s_nrm, s_nrm) < 0.5))
    ndiff = jnp.where(both_bg, 0.0,
                      jnp.maximum(1.0 - dot(s_nrm, normal), 0.0))
    da = s_alb - albedo
    f = jnp.stack([
        jnp.abs(_luminance(s_col) - lum_p) / (gstd + 1e-4),
        ndiff,
        dot(da, da),
        gstd,
        jnp.full_like(lum_p, it / max(iterations - 1, 1)),
        jnp.full_like(lum_p, radius),
    ], axis=-1)
    return f


def _mlp_logit(params, f):
    # full float32: the weights were fitted on the CPU, and the MLP is too
    # small for TF32 to save time
    mm = functools.partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)
    h = jnp.maximum(mm(f, params["w1"]) + params["b1"], 0.0)
    return (mm(h, params["w2"]) + params["b2"])[..., 0]


def learned_denoise(color, albedo, normal, variance, params,
                    iterations: int = 4):
    """À-trous filtering with LEARNED tap weights (the OIDN-role learned
    prior, sized as a per-tap MLP instead of a conv net: the reference ships
    OIDN 2.3.3, DenoiserContext.mm:251).

    Same pyramid/variance propagation as svgf_denoise, but the per-tap
    weight is w_k * exp(-softplus(mlp(features))): a ~300-parameter MLP on
    (variance-normalized luminance delta, normal/albedo deltas, local
    noise level, iteration, tap radius), trained end-to-end THROUGH the
    filter — through both iteration counts denoise_state runs (4 and 5)
    — against high-spp references (tools/train_denoiser.py). softplus >= 0 keeps every weight <= the
    B3-spline tap weight, so the filter can only sharpen relative to a
    plain blur — the same falloff structure the hand-tuned filters use.
    """
    out = color
    var = _luminance(variance)

    for it in range(iterations):
        step = 1 << it
        # the 1e-12 floor keeps sqrt differentiable where variance is
        # identically zero (converged regions NaN'd the training grads)
        gstd = jnp.sqrt(jnp.maximum(_gauss3(var), 1e-12))
        lum_p = _luminance(out)
        accum = jnp.zeros_like(out)
        var_accum = jnp.zeros_like(var)
        weight_sum = jnp.zeros(out.shape[:2], out.dtype)
        for ky, wy in zip((-2, -1, 0, 1, 2), _KERNEL):
            for kx, wx in zip((-2, -1, 0, 1, 2), _KERNEL):
                w_k = wy * wx
                shift = (ky * step, kx * step)
                s_col = jnp.roll(out, shift, axis=(0, 1))
                s_var = jnp.roll(var, shift, axis=(0, 1))
                s_alb = jnp.roll(albedo, shift, axis=(0, 1))
                s_nrm = jnp.roll(normal, shift, axis=(0, 1))
                f = _tap_features(lum_p, gstd, normal, albedo,
                                  s_col, s_nrm, s_alb, it,
                                  (abs(ky) + abs(kx)) / 4.0, iterations)
                z = _mlp_logit(params, f)
                w = w_k * jnp.exp(-jax.nn.softplus(z))
                accum = accum + s_col * w[..., None]
                var_accum = var_accum + s_var * (w * w)
                weight_sum = weight_sum + w
        out = accum / jnp.maximum(weight_sum, 1e-6)[..., None]
        var = var_accum / jnp.maximum(weight_sum, 1e-6) ** 2
    return out


_LEARNED_PARAMS = None
_UNET_PARAMS = None


def _unet_params():
    """Vendored conv U-Net weights (data/denoiser_unet.npz); None if
    absent or disabled via MPT_UNET_DENOISE=0."""
    global _UNET_PARAMS
    import os

    if os.environ.get("MPT_UNET_DENOISE", "1") != "1":
        return None
    if _UNET_PARAMS is None:
        path = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "data", "denoiser_unet.npz")
        if not os.path.exists(path):
            _UNET_PARAMS = False
        else:
            import numpy as np

            with np.load(path) as z:
                _UNET_PARAMS = {k: jnp.asarray(z[k]) for k in z.files}
    return _UNET_PARAMS or None


def _learned_params():
    """Vendored weights (data/denoiser_weights.npz); None if absent or
    disabled via MPT_LEARNED_DENOISE=0."""
    global _LEARNED_PARAMS
    import os

    if os.environ.get("MPT_LEARNED_DENOISE", "1") != "1":
        return None
    if _LEARNED_PARAMS is None:
        path = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "data", "denoiser_weights.npz")
        if not os.path.exists(path):
            _LEARNED_PARAMS = False
        else:
            import numpy as np

            with np.load(path) as z:
                _LEARNED_PARAMS = {k: jnp.asarray(z[k]) for k in z.files}
    return _LEARNED_PARAMS or None


def denoise_state(state, settings):
    """Denoise the averaged image using the RenderState AOVs; returns the
    denoised (H,W,3) image. Normal AOV is stored in [0,1] encoding.

    Filter choice, best first: conv U-Net (the OIDN-class prior,
    ops/denoise_unet.py) -> learned tap weights -> SVGF-style variance
    guiding -> fixed-sigma à-trous (resumes from pre-sq_sum
    checkpoints)."""
    avg = state.present()
    iterations = 5 if settings.denoiseFilterType == 1 else 4
    normal = state.normal  # already world-space unit (pre-encode)
    if state.radiance_sq_sum is not None:
        uparams = _unet_params()
        tparams = _learned_params()
        if uparams is not None:
            from metal_pathtracer.ops import denoise_unet

            var = state.variance_of_mean()
            # the U-Net refines the tap-filter prepass (its training base;
            # svgf is the close-enough fallback when taps are absent)
            if tparams is not None:
                base = learned_denoise(avg, state.albedo, normal, var,
                                       tparams, iterations=iterations)
            else:
                base = svgf_denoise(avg, state.albedo, normal, var,
                                    iterations=iterations)
            return denoise_unet.denoise(avg, state.albedo, normal, var,
                                        uparams, base)
        params = tparams
        # the vendored MLP is trained end-to-end through BOTH iteration
        # counts denoise_state can run (4 = RT, 5 = RTLightmap); other
        # depths would be out-of-distribution -> hand-tuned SVGF
        if params is not None and iterations in (4, 5):
            return learned_denoise(avg, state.albedo, normal,
                                   state.variance_of_mean(), params,
                                   iterations=iterations)
        return svgf_denoise(avg, state.albedo, normal,
                            state.variance_of_mean(),
                            iterations=iterations)
    return atrous_denoise(avg, state.albedo, normal, iterations=iterations)
