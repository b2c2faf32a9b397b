#!/usr/bin/env python
"""Train the learned denoiser tap-weight MLP (ops/denoise.learned_denoise).

Renders a small set of procedural training scenes (NOT the quality-gate
cornell scene — that one is held out by tests/test_denoise_quality.py) at
16 spp with AOVs + variance, plus 512-spp references, then optimizes the
~300-parameter MLP end-to-end through the 4-iteration à-trous filter with
Adam on relative-MSE. Writes metal_pathtracer/data/denoiser_weights.npz.

Trains through BOTH iteration counts denoise_state can run (4 and 5).
Runs on CPU in ~40 minutes: `python tools/train_denoiser.py`.
Deterministic (fixed seeds) so the vendored weights are reproducible.
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from metal_pathtracer.ops import denoise  # noqa: E402
from metal_pathtracer.scene import dsl  # noqa: E402
from metal_pathtracer.scene.resources import SceneResources  # noqa: E402
from metal_pathtracer.settings import RenderSettings  # noqa: E402

W = H = 64
SPP_IN = 16
SPP_REF = 512
ITERS = 4
STEPS = 600

def _env_scene(subdivisions=2):
    """A toy bench-class scene: HDR sun/sky env alias NEE + dielectric +
    lambert — the noise character the headline/viewer scenes have."""
    from metal_pathtracer.utils.benchscene import build_bench_scene

    settings, res, environment = build_bench_scene(subdivisions)
    settings.maxDepth = 5
    # drop textures: keep the material mix simple for the 64x64 crop
    res.texture_images.clear()
    res.texture_srgb.clear()
    res.texture_wrap.clear()
    for m in res.materials:
        m.texture_indices = (-1, -1, -1, -1, -1, -1)
    return settings, res, environment


def _env_scene_dim(subdivisions=2):
    settings, res, environment = _env_scene(subdivisions)
    settings.environmentIntensity = 0.25
    settings.cameraYaw += 1.2
    settings.fixedRngSeed = 77
    return settings, res, environment



# Training scenes: spheres, metal, dielectric, colored walls, emissive
# rects, open sky — diverse transport, all distinct from the held-out
# cornell gate scene in tests/test_denoise_quality.py.
SCENES = [
    # box with a diffuse sphere + side light
    """camera target=0,1,0 distance=4.2 yaw=1.2 pitch=-0.1 vfov=42
renderer maxDepth=4 seed=11
material type=lambert albedo=0.7,0.7,0.68
material type=lambert albedo=0.2,0.3,0.7
material type=light emit=10,9,8
sphere center=0,0.7,0 radius=0.7 material=1
rectangle x=-2,2 y=0 z=-2,2 normal=1 material=0
rectangle x=-1,0.2 y=2.4 z=-1,1 normal=-1 material=2
""",
    # metal + lambert spheres under a bright sky gradient
    """camera target=0,0.5,0 distance=5 yaw=0.3 pitch=-0.15 vfov=38
renderer maxDepth=5 seed=23
background solid=0.65,0.75,0.95
material type=metal albedo=0.9,0.75,0.5 roughness=0.15
material type=lambert albedo=0.6,0.15,0.12
material type=lambert albedo=0.45,0.45,0.45
sphere center=-0.9,0.5,0 radius=0.5 material=0
sphere center=0.9,0.5,0 radius=0.5 material=1
sphere center=0,-100,0 radius=100 material=2
""",
    # glass sphere over checker-ish floor with a small hot light
    """camera target=0,0.6,0 distance=3.6 yaw=2.0 pitch=-0.2 vfov=45
renderer maxDepth=6 seed=37
material type=dielectric ior=1.5
material type=lambert albedo=0.55,0.55,0.5
material type=light emit=18,16,12
sphere center=0,0.6,0 radius=0.6 material=0
rectangle x=-3,3 y=0 z=-3,3 normal=1 material=1
rectangle x=-0.5,0.5 y=2.8 z=-0.5,0.5 normal=-1 material=2
""",
    # saturated colored box, strong indirect
    """camera target=0,1,0 distance=3.9 yaw=-1.5708 pitch=0 vfov=40
renderer maxDepth=4 seed=41
material type=lambert albedo=0.73,0.73,0.73
material type=lambert albedo=0.1,0.1,0.6
material type=lambert albedo=0.7,0.55,0.05
material type=light emit=13,13,13
rectangle x=-1,1 y=0 z=-1,1 normal=1 material=0
rectangle x=-1,1 y=2 z=-1,1 normal=-1 material=0
rectangle x=-1 y=0,2 z=-1,1 normal=1 material=1
rectangle x=1 y=0,2 z=-1,1 normal=-1 material=2
rectangle x=-1,1 y=0,2 z=1 normal=-1 material=0
rectangle x=-0.5,0.5 y=1.99 z=-0.5,0.5 normal=-1 material=3
""",
    # dim scene (noise level much higher), emissive sphere
    """camera target=0,0.8,0 distance=4.5 yaw=0.7 pitch=-0.1 vfov=40
renderer maxDepth=4 seed=53
material type=lambert albedo=0.5,0.5,0.5
material type=light emit=4,5,7
material type=metal albedo=0.8,0.8,0.85 roughness=0.35
sphere center=0.8,0.5,0.4 radius=0.5 material=2
sphere center=-0.9,0.9,-0.5 radius=0.35 material=1
rectangle x=-3,3 y=0 z=-3,3 normal=1 material=0
""",
    _env_scene,       # HDR env alias NEE (the headline scene's class)
    _env_scene_dim,   # same under 0.25x intensity (high-noise regime)
]


def render_pair(spec):
    from metal_pathtracer.ops.camera import build_camera
    from metal_pathtracer.renderer import frame
    from metal_pathtracer.renderer.accumulation import RenderState
    from metal_pathtracer.schema import (
        settings_to_static,
        settings_to_uniforms,
    )

    if callable(spec):
        settings, res, environment = spec()
    else:
        settings = RenderSettings()
        res = SceneResources()
        dsl.parse_scene(spec, settings, res)
        environment = None
    scene = res.build_arrays(environment=environment)
    static = settings_to_static(settings, W, H, res.material_types_present())
    cam = build_camera(settings, W, H)
    uni = settings_to_uniforms(settings, cam, 0, 0)
    ref = frame.render_samples(scene, uni, RenderState.create(W, H),
                               static, SPP_REF)
    st = frame.render_samples(scene, uni, RenderState.create(W, H),
                              static, SPP_IN)
    return {
        "noisy": np.asarray(st.present()),
        "albedo": np.asarray(st.albedo),
        "normal": np.asarray(st.normal),
        "variance": np.asarray(st.variance_of_mean()),
        "ref": np.asarray(ref.present()),
    }


def init_params(key, n_feat=6, hidden=16):
    """Initialize the net to REPLICATE the hand-tuned SVGF weight, then let
    training move it: -log(w/w_k) = f0/sigma_lum + 64*ndiff + 8*||da||^2
    (softplus(z) ~ z for the mostly-positive z this produces). Hidden unit
    j passes feature j through relu (features are >= 0); w2 carries the
    SVGF coefficients; remaining units start small-random."""
    k1, k2 = jax.random.split(key)
    w1 = jax.random.normal(k1, (n_feat, hidden)) * 0.02
    w2 = jax.random.normal(k2, (hidden, 1)) * 0.02
    w1 = w1.at[:, :n_feat].add(jnp.eye(n_feat))
    coef = jnp.zeros((hidden, 1))
    coef = coef.at[0, 0].set(1.0 / 1.5)   # f0 = |dlum|/(gstd+eps)
    coef = coef.at[1, 0].set(64.0)        # ndiff ~ -log(ndot^64)
    coef = coef.at[2, 0].set(8.0)         # ||dalbedo||^2 / (2*0.25^2)
    return {
        "w1": w1,
        "b1": jnp.zeros(hidden),
        "w2": w2 + coef,
        "b2": jnp.zeros(1),
    }


def _cache_path():
    """Cache keyed by the scene specs + render config, so edits to the
    DSL scenes, the env-scene builders (incl. their transport defaults
    via benchscene), or W/H/spp invalidate stale renders."""
    import hashlib
    import inspect

    from metal_pathtracer.utils import benchscene

    key = hashlib.sha1()
    for spec in SCENES:
        key.update((spec if isinstance(spec, str)
                    else inspect.getsource(spec)).encode())
    key.update(inspect.getsource(benchscene.build_bench_scene).encode())
    key.update(f"{W}x{H}:{SPP_IN}:{SPP_REF}".encode())
    return f"/tmp/denoiser_train_data_{key.hexdigest()[:12]}.npz"


def main():
    t0 = time.time()
    cache = _cache_path()
    if os.path.exists(cache):
        with np.load(cache) as z:
            stacked = {k: z[k] for k in z.files}
        print(f"loaded cached renders {cache}", flush=True)
    else:
        data = []
        for i, text in enumerate(SCENES):
            d = render_pair(text)
            noisy_err = float(np.sqrt(np.mean((d["noisy"] - d["ref"]) ** 2)))
            svgf = denoise.svgf_denoise(
                jnp.asarray(d["noisy"]), jnp.asarray(d["albedo"]),
                jnp.asarray(d["normal"]), jnp.asarray(d["variance"]),
                iterations=ITERS)
            svgf_err = float(np.sqrt(np.mean(
                (np.asarray(svgf) - d["ref"]) ** 2)))
            print(f"scene {i}: noisy rmse={noisy_err:.4f} "
                  f"svgf={svgf_err:.4f} ({time.time() - t0:.0f}s)",
                  flush=True)
            data.append(d)
        stacked = {k: np.stack([d[k] for d in data]) for k in data[0]}
        np.savez(cache, **stacked)
    data_j = {k: jnp.asarray(v) for k, v in stacked.items()}
    n_scenes = data_j["ref"].shape[0]

    # one vmapped filter over the scene axis -> ONE compile for the whole
    # step (per-scene python-loop graphs compiled for minutes on CPU).
    # Trains through BOTH iteration counts denoise_state can run (4 = RT,
    # 5 = RTLightmap) so the weights are in-distribution for either.
    def one_scene_sq_err(params, noisy, albedo, normal, variance, ref):
        scale = jnp.mean(ref ** 2) + 1e-3  # relative MSE: dim scenes count
        err = 0.0
        for iters in (ITERS, ITERS + 1):
            out = denoise.learned_denoise(noisy, albedo, normal, variance,
                                          params, iterations=iters)
            err = err + jnp.mean((out - ref) ** 2) / scale
        return err / 2.0

    def loss_fn(params):
        errs = jax.vmap(one_scene_sq_err,
                        in_axes=(None, 0, 0, 0, 0, 0))(
            params, data_j["noisy"], data_j["albedo"], data_j["normal"],
            data_j["variance"], data_j["ref"])
        return jnp.mean(errs)

    params = init_params(jax.random.PRNGKey(0))
    opt = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(1e-3))
    opt_state = opt.init(params)
    val_and_grad = jax.jit(jax.value_and_grad(loss_fn))

    best = None
    best_loss = np.inf
    for step in range(STEPS):
        loss, grads = val_and_grad(params)
        if not np.isfinite(float(loss)):
            print(f"step {step}: non-finite loss, stopping", flush=True)
            break
        updates, opt_state = opt.update(grads, opt_state)
        params = optax.apply_updates(params, updates)
        if float(loss) < best_loss:
            best_loss = float(loss)
            best = jax.tree.map(np.asarray, params)
        if step % 50 == 0 or step == STEPS - 1:
            print(f"step {step}: loss {float(loss):.5f} "
                  f"({time.time() - t0:.0f}s)", flush=True)

    if best is None:
        print("training produced no finite loss; weights NOT written")
        sys.exit(1)
    out_dir = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "metal_pathtracer", "data")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "denoiser_weights.npz")
    np.savez(path, **best)
    print(f"wrote {path} (best loss {best_loss:.5f})")

    # report train-set improvement vs svgf with the saved weights
    bp = {k: jnp.asarray(v) for k, v in best.items()}
    for i in range(n_scenes):
        out = denoise.learned_denoise(
            data_j["noisy"][i], data_j["albedo"][i], data_j["normal"][i],
            data_j["variance"][i], bp, iterations=ITERS)
        sv = denoise.svgf_denoise(
            data_j["noisy"][i], data_j["albedo"][i], data_j["normal"][i],
            data_j["variance"][i], iterations=ITERS)
        err = float(jnp.sqrt(jnp.mean((out - data_j["ref"][i]) ** 2)))
        esv = float(jnp.sqrt(jnp.mean((sv - data_j["ref"][i]) ** 2)))
        print(f"scene {i}: learned rmse={err:.4f} vs svgf {esv:.4f}")


if __name__ == "__main__":
    main()
