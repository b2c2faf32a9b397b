"""Small convolutional U-Net denoiser (the OIDN-class learned prior).

The reference ships Intel Open Image Denoise 2.3.3 and feeds it color +
albedo + normal auxiliary images (`/root/reference/src/renderer/
DenoiserContext.mm:251,316-481`). OIDN's RT filter is a U-Net trained on
log-transformed HDR with albedo/normal guides; this is the same design
scaled to this repo's training budget: a 3-level U-Net (~90k params,
pure `lax.conv_general_dilated` NHWC convs) on
(log1p color, albedo, normal, sqrt variance), predicting a residual in
log space. Weights are trained by `tools/train_denoiser_unet.py` against
512-spp references and vendored in `data/denoiser_unet.npz`; the
tap-weight a-trous filter (`denoise.learned_denoise`) remains the
fallback when the conv weights are absent.

Layout: enc1(16) -> pool -> enc2(24) -> pool -> enc3(32) -> pool ->
bottleneck(48) -> up+skip dec3(32) -> up+skip dec2(24) -> up+skip
dec1(16) -> out(3). All convs 3x3 SAME + ReLU; pools are 2x2 max;
upsampling is nearest-neighbor (cheap and artifact-free under the
residual head). Inputs are padded to a multiple of 8 and cropped back,
so any resolution works (1080p is already divisible).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# (name, in_ch, out_ch) for every conv, in forward order. IN_CH features:
# log1p(base) 3 + log1p(noisy color) 3 + albedo 3 + normal 3 +
# sqrt(luma variance) 1, where `base` is the tap-filter prepass output —
# the U-Net refines an already-strong baseline (residual-on-base; the
# noisy color channel lets it restore detail the prepass over-smoothed).
IN_CH = 13
_ENC = (("enc1", IN_CH, 16), ("enc2", 16, 24), ("enc3", 24, 32))
_BOTTLE = ("bottle", 32, 48)
_DEC = (("dec3", 48 + 32, 32), ("dec2", 32 + 24, 24), ("dec1", 24 + 16, 16))
_OUT = ("out", 16, 3)
LAYERS = _ENC + (_BOTTLE,) + _DEC + (_OUT,)


def init_params(key):
    """He-normal init; the output conv starts SMALL (0.05x He) — near-
    identity under the residual head — but NOT zero: a zero-init output
    conv is a gradient trap here (all trunk gradients flow through
    out_w, which only grows if the untrained features already correlate
    with the noise; measured converging to a dead stationary point,
    gnorm -> 0 at the identity)."""
    params = {}
    for name, cin, cout in LAYERS:
        key, k1 = jax.random.split(key)
        scale = jnp.sqrt(2.0 / (9 * cin))
        w = jax.random.normal(k1, (3, 3, cin, cout), jnp.float32) * scale
        if name == "out":
            w = w * 0.05
        params[name + "_w"] = w
        params[name + "_b"] = jnp.zeros((cout,), jnp.float32)
    return params


def _conv(params, name, x, relu=True):
    # full float32, so the card filters as the CPU-trained, CPU-gated
    # weights expect (TF32 would perturb every tap ~1e-3 relative)
    y = jax.lax.conv_general_dilated(
        x, params[name + "_w"], (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision=jax.lax.Precision.HIGHEST)
    y = y + params[name + "_b"]
    # leaky (0.1): plain ReLU measured a total dying-ReLU collapse in
    # training — Adam silences the initially-random residual by driving
    # every trunk bias negative, and a fully dead net is an exact
    # stationary point (gnorm == 0 at the identity)
    return jnp.where(y > 0.0, y, 0.1 * y) if relu else y


def _pool(x):
    return jax.lax.reduce_window(x, -jnp.inf, jax.lax.max,
                                 (1, 2, 2, 1), (1, 2, 2, 1), "VALID")


def _up(x):
    n, h, w, c = x.shape
    return jnp.broadcast_to(x[:, :, None, :, None, :],
                            (n, h, 2, w, 2, c)).reshape(n, 2 * h, 2 * w, c)


def apply(params, feats):
    """feats: (N, H, W, IN_CH) with H, W divisible by 8. Returns the
    log-space residual (N, H, W, 3)."""
    e1 = _conv(params, "enc1", feats)
    e2 = _conv(params, "enc2", _pool(e1))
    e3 = _conv(params, "enc3", _pool(e2))
    b = _conv(params, "bottle", _pool(e3))
    d3 = _conv(params, "dec3", jnp.concatenate([_up(b), e3], -1))
    d2 = _conv(params, "dec2", jnp.concatenate([_up(d3), e2], -1))
    d1 = _conv(params, "dec1", jnp.concatenate([_up(d2), e1], -1))
    return _conv(params, "out", d1, relu=False)


def _features(base, color, albedo, normal, variance):
    lum_var = (0.2126 * variance[..., 0] + 0.7152 * variance[..., 1]
               + 0.0722 * variance[..., 2])
    return jnp.concatenate([
        jnp.log1p(jnp.maximum(base, 0.0)),
        jnp.log1p(jnp.maximum(color, 0.0)),
        albedo,
        normal,
        jnp.sqrt(jnp.maximum(lum_var, 0.0))[..., None],
    ], -1)


def denoise(color, albedo, normal, variance, params, base):
    """Refine one (H, W, 3) linear-HDR image. `base` is the tap-filter
    prepass output (denoise.learned_denoise / svgf fallback); the net
    predicts a residual in log1p space on top of it:
    out = expm1(relu(log1p(base) + unet(feats))). relu keeps radiance
    non-negative."""
    h, w = color.shape[:2]
    ph = (-h) % 8
    pw = (-w) % 8
    feats = _features(base, color, albedo, normal, variance)
    if ph or pw:
        feats = jnp.pad(feats, ((0, ph), (0, pw), (0, 0)), mode="edge")
    res = apply(params, feats[None])[0]
    log_out = jnp.log1p(jnp.maximum(
        jnp.pad(base, ((0, ph), (0, pw), (0, 0)), mode="edge")
        if ph or pw else base, 0.0)) + res
    out = jnp.expm1(jnp.maximum(log_out, 0.0))
    return out[:h, :w]
