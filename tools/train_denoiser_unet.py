#!/usr/bin/env python
"""Train the conv U-Net denoiser (ops/denoise_unet.py, the OIDN-class
learned prior; the reference ships OIDN 2.3.3, DenoiserContext.mm:251).

Reuses tools/train_denoiser.py's scene set and cached render pipeline at
96x96 (16-spp noisy + AOVs + variance vs 512-spp references), then
optimizes the ~90k-parameter U-Net on random 64x64 crops with flip /
transpose / exposure augmentation, relative-MSE loss in linear HDR.
The cornell gate scene (tests/test_denoise_quality.py) stays held out:
it is never rendered here, not even for model selection — training runs
a fixed schedule and the test is the only judge.

Writes metal_pathtracer/data/denoiser_unet.npz. Deterministic
(fixed seeds). Runs on CPU: ~1.5h first time (renders), ~10 min from
cached renders.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from metal_pathtracer.ops import denoise_unet as unet  # noqa: E402
from tools import train_denoiser as td  # noqa: E402

# render the shared scene set at a larger tile than the tap trainer (the
# conv net needs spatial context; 96 is divisible by 8 at every level)
td.W = td.H = 96

CROP = 64
BATCH = 8
STEPS = 5000

# Extra enclosed-GI scenes for the conv net (the tap trainer's set is
# mostly open/env-lit; the held-out cornell gate measured the U-Net
# generalizing worse than the tap filter without box coverage). All
# differ from the gate scene in dimensions, wall colors, light
# size/position/intensity, contents, and camera.
EXTRA_SCENES = [
    # tall box, warm small light, two diffuse spheres
    """camera target=0,1.2,0 distance=4.6 yaw=1.35 pitch=-0.05 vfov=38
renderer maxDepth=5 seed=101
material type=lambert albedo=0.68,0.66,0.62
material type=lambert albedo=0.55,0.12,0.5
material type=lambert albedo=0.15,0.5,0.55
material type=light emit=22,17,9
sphere center=-0.5,0.45,0.3 radius=0.45 material=1
sphere center=0.6,0.35,-0.4 radius=0.35 material=2
rectangle x=-1.3,1.3 y=0 z=-1.3,1.3 normal=1 material=0
rectangle x=-1.3,1.3 y=2.8 z=-1.3,1.3 normal=-1 material=0
rectangle x=-1.3 y=0,2.8 z=-1.3,1.3 normal=1 material=1
rectangle x=1.3 y=0,2.8 z=-1.3,1.3 normal=-1 material=2
rectangle x=-1.3,1.3 y=0,2.8 z=-1.3 normal=1 material=0
rectangle x=-0.25,0.25 y=2.79 z=-0.25,0.25 normal=-1 material=3
""",
    # wide shallow box, big dim ceiling light, metal sphere
    """camera target=0,0.8,0 distance=3.4 yaw=-1.45 pitch=-0.1 vfov=46
renderer maxDepth=4 seed=103
material type=lambert albedo=0.75,0.71,0.68
material type=metal albedo=0.85,0.82,0.75 roughness=0.25
material type=lambert albedo=0.6,0.35,0.1
material type=light emit=5,5,6
sphere center=0,0.5,0 radius=0.5 material=1
rectangle x=-1.6,1.6 y=0 z=-1,1 normal=1 material=0
rectangle x=-1.6,1.6 y=1.8 z=-1,1 normal=-1 material=0
rectangle x=-1.6 y=0,1.8 z=-1,1 normal=1 material=2
rectangle x=1.6 y=0,1.8 z=-1,1 normal=-1 material=2
rectangle x=-1.6,1.6 y=0,1.8 z=-1 normal=1 material=0
rectangle x=-1.1,1.1 y=1.79 z=-0.7,0.7 normal=-1 material=3
""",
    # glass sphere in a box, hot side light (caustic-ish noise)
    """camera target=0,0.9,0 distance=4.1 yaw=1.7 pitch=-0.12 vfov=41
renderer maxDepth=6 seed=107
material type=lambert albedo=0.7,0.7,0.7
material type=dielectric ior=1.5
material type=lambert albedo=0.2,0.25,0.6
material type=light emit=30,27,21
sphere center=0,0.62,0 radius=0.6 material=1
rectangle x=-1.2,1.2 y=0 z=-1.2,1.2 normal=1 material=0
rectangle x=-1.2,1.2 y=2.2 z=-1.2,1.2 normal=-1 material=0
rectangle x=-1.2 y=0,2.2 z=-1.2,1.2 normal=1 material=2
rectangle x=1.2 y=0,2.2 z=-1.2,1.2 normal=-1 material=0
rectangle x=-1.2,1.2 y=0,2.2 z=-1.2 normal=1 material=0
rectangle x=1.19 y=1.2,1.9 z=-0.4,0.4 normal=-1 material=3
""",
    # dim green-tinted box, offset light, high-noise regime
    """camera target=0,1,0 distance=3.7 yaw=-1.6 pitch=0.05 vfov=43
renderer maxDepth=4 seed=109
material type=lambert albedo=0.62,0.7,0.6
material type=lambert albedo=0.3,0.55,0.25
material type=lambert albedo=0.5,0.48,0.45
material type=light emit=6,7,5
sphere center=0.4,0.4,0.3 radius=0.4 material=2
rectangle x=-1.1,1.1 y=0 z=-1.1,1.1 normal=1 material=0
rectangle x=-1.1,1.1 y=2.1 z=-1.1,1.1 normal=-1 material=0
rectangle x=-1.1 y=0,2.1 z=-1.1,1.1 normal=1 material=1
rectangle x=1.1 y=0,2.1 z=-1.1,1.1 normal=-1 material=1
rectangle x=-1.1,1.1 y=0,2.1 z=-1.1 normal=1 material=0
rectangle x=0.3,0.9 y=2.09 z=-0.7,-0.1 normal=-1 material=3
""",
]


def load_data():
    import hashlib

    cache = td._cache_path()
    if os.path.exists(cache):
        with np.load(cache) as z:
            base = {k: z[k] for k in z.files}
    else:
        data = []
        t0 = time.time()
        for i, spec in enumerate(td.SCENES):
            d = td.render_pair(spec)
            err = float(np.sqrt(np.mean((d["noisy"] - d["ref"]) ** 2)))
            print(f"scene {i}: noisy rmse={err:.4f} ({time.time()-t0:.0f}s)",
                  flush=True)
            data.append(d)
        base = {k: np.stack([d[k] for d in data]) for k in data[0]}
        np.savez(cache, **base)

    key = hashlib.sha1()
    for s in EXTRA_SCENES:
        key.update(s.encode())
    key.update(f"{td.W}x{td.H}:{td.SPP_IN}:{td.SPP_REF}".encode())
    cache2 = f"/tmp/denoiser_unet_extra_{key.hexdigest()[:12]}.npz"
    if os.path.exists(cache2):
        with np.load(cache2) as z:
            extra = {k: z[k] for k in z.files}
    else:
        data = []
        t0 = time.time()
        for i, spec in enumerate(EXTRA_SCENES):
            d = td.render_pair(spec)
            err = float(np.sqrt(np.mean((d["noisy"] - d["ref"]) ** 2)))
            print(f"extra scene {i}: noisy rmse={err:.4f} "
                  f"({time.time()-t0:.0f}s)", flush=True)
            data.append(d)
        extra = {k: np.stack([d[k] for d in data]) for k in data[0]}
        np.savez(cache2, **extra)
    return {k: np.concatenate([base[k], extra[k]]) for k in base}


def main():
    from metal_pathtracer.ops import denoise

    data = load_data()
    n_scenes = data["ref"].shape[0]
    # tap-filter prepass: the base the net refines (same as inference;
    # denoise_state falls back to svgf only when taps are absent)
    tparams = denoise._learned_params()
    bases = []
    for i in range(n_scenes):
        args = (jnp.asarray(data["noisy"][i]), jnp.asarray(data["albedo"][i]),
                jnp.asarray(data["normal"][i]),
                jnp.asarray(data["variance"][i]))
        if tparams is not None:
            bases.append(np.asarray(denoise.learned_denoise(
                *args, tparams, iterations=4)))
        else:
            bases.append(np.asarray(denoise.svgf_denoise(*args,
                                                         iterations=4)))
    base = np.stack(bases).astype(np.float32)
    feats = np.asarray(jax.vmap(unet._features)(
        jnp.asarray(base),
        jnp.asarray(data["noisy"]), jnp.asarray(data["albedo"]),
        jnp.asarray(data["normal"]), jnp.asarray(data["variance"])))
    noisy = data["noisy"].astype(np.float32)
    ref = data["ref"].astype(np.float32)

    params = unet.init_params(jax.random.PRNGKey(0))
    sched = optax.cosine_decay_schedule(2e-3, STEPS, alpha=0.05)
    opt = optax.adam(sched)
    opt_state = opt.init(params)

    def loss_fn(params, f, b, r):
        res = unet.apply(params, f)
        log_b = jnp.log1p(jnp.maximum(b, 0.0))
        log_r = jnp.log1p(jnp.maximum(r, 0.0))
        # primary: regress the log-space residual directly (well-
        # conditioned; OIDN trains on log-transformed HDR too) — the
        # linear relMSE alone left gradients too weak to escape the
        # near-identity region
        log_mse = jnp.mean((log_b + res - log_r) ** 2)
        out = jnp.expm1(jnp.maximum(log_b + res, 0.0))
        # relative MSE per crop: dim scenes count as much as bright ones
        scale = jnp.mean(r * r, axis=(1, 2, 3), keepdims=True) + 1e-3
        rel = jnp.mean((out - r) ** 2 / scale)
        return log_mse + 0.25 * rel

    @jax.jit
    def step(params, opt_state, f, x, r):
        loss, g = jax.value_and_grad(loss_fn)(params, f, x, r)
        updates, opt_state = opt.update(g, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    rng = np.random.default_rng(7)
    t0 = time.time()
    for s in range(STEPS):
        idx = rng.integers(0, n_scenes, BATCH)
        ys = rng.integers(0, td.H - CROP + 1, BATCH)
        xs = rng.integers(0, td.W - CROP + 1, BATCH)
        fb = np.stack([feats[i, y:y + CROP, x:x + CROP]
                       for i, y, x in zip(idx, ys, xs)])
        bb = np.stack([base[i, y:y + CROP, x:x + CROP]
                       for i, y, x in zip(idx, ys, xs)])
        xb = np.stack([noisy[i, y:y + CROP, x:x + CROP]
                       for i, y, x in zip(idx, ys, xs)])
        rb = np.stack([ref[i, y:y + CROP, x:x + CROP]
                       for i, y, x in zip(idx, ys, xs)])
        # geometric augmentation (guide channels ride along — they only
        # need to stay spatially aligned) + exposure augmentation (the
        # tap prepass is treated as scale-equivariant: base *= s is a
        # close approximation, its filter weights are mostly ratio-based)
        for b in range(BATCH):
            if rng.random() < 0.5:
                fb[b], bb[b], xb[b], rb[b] = (
                    fb[b, :, ::-1], bb[b, :, ::-1], xb[b, :, ::-1],
                    rb[b, :, ::-1])
            if rng.random() < 0.5:
                fb[b], bb[b], xb[b], rb[b] = (
                    fb[b, ::-1], bb[b, ::-1], xb[b, ::-1], rb[b, ::-1])
            if rng.random() < 0.5:
                fb[b] = np.swapaxes(fb[b], 0, 1)
                bb[b] = np.swapaxes(bb[b], 0, 1)
                xb[b] = np.swapaxes(xb[b], 0, 1)
                rb[b] = np.swapaxes(rb[b], 0, 1)
            s_exp = float(np.exp(rng.uniform(-1.2, 1.2)))
            bb[b] *= s_exp
            xb[b] *= s_exp
            rb[b] *= s_exp
            # feature channels: 0-2 log1p(base), 3-5 log1p(color),
            # 12 sqrt(luma var)
            fb[b, ..., 0:3] = np.log1p(np.maximum(bb[b], 0.0))
            fb[b, ..., 3:6] = np.log1p(np.maximum(xb[b], 0.0))
            fb[b, ..., 12] *= s_exp
        params, opt_state, loss = step(params, opt_state,
                                       jnp.asarray(fb), jnp.asarray(bb),
                                       jnp.asarray(rb))
        if s % 200 == 0 or s == STEPS - 1:
            print(f"step {s}: loss={float(loss):.5f} "
                  f"({time.time()-t0:.0f}s)", flush=True)

    # full-image training-set report (no selection, just logging)
    for i in range(n_scenes):
        out = np.asarray(unet.denoise(
            jnp.asarray(noisy[i]), jnp.asarray(data["albedo"][i]),
            jnp.asarray(data["normal"][i]),
            jnp.asarray(data["variance"][i]), params,
            jnp.asarray(base[i])))
        e_n = float(np.sqrt(np.mean((noisy[i] - ref[i]) ** 2)))
        e_b = float(np.sqrt(np.mean((base[i] - ref[i]) ** 2)))
        e_u = float(np.sqrt(np.mean((out - ref[i]) ** 2)))
        print(f"scene {i}: noisy={e_n:.4f} taps={e_b:.4f} unet={e_u:.4f}",
              flush=True)

    out_path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "metal_pathtracer", "data",
        "denoiser_unet.npz")
    np.savez(out_path, **{k: np.asarray(v) for k, v in params.items()})
    print(f"wrote {out_path}")


if __name__ == "__main__":
    main()
