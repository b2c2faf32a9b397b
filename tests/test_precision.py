"""Every float32 contraction on the main path names its precision.

A dot or convolution left at the default precision may run in TF32 on a
tensor-core GPU (~1e-3 relative). The geometry (instance transforms), the
color matrices and the denoisers are traced here, and every dot_general /
conv_general_dilated in their jaxprs must carry Precision.HIGHEST.
"""

import jax
import jax.extend
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax

HIGHEST = lax.Precision.HIGHEST


def _contractions(jaxpr):
    """(primitive name, precision) of every dot/conv, sub-jaxprs included."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name in ("dot_general", "conv_general_dilated"):
            out.append((eqn.primitive.name, eqn.params.get("precision")))
        for v in eqn.params.values():
            for sub in v if isinstance(v, (tuple, list)) else (v,):
                if isinstance(sub, jax.extend.core.ClosedJaxpr):
                    out.extend(_contractions(sub.jaxpr))
                elif isinstance(sub, jax.extend.core.Jaxpr):
                    out.extend(_contractions(sub))
    return out


def _all_highest(fn, *args):
    found = _contractions(jax.make_jaxpr(fn)(*args).jaxpr)
    for name, prec in found:
        precs = prec if isinstance(prec, tuple) else (prec, prec)
        assert all(p == HIGHEST for p in precs), (name, prec)
    return found


def _instanced_acescg():
    from metal_pathtracer.ops.camera import build_camera
    from metal_pathtracer.renderer.accumulation import RenderState
    from metal_pathtracer.scene.resources import Material, SceneResources
    from metal_pathtracer.schema import settings_to_static, \
        settings_to_uniforms
    from metal_pathtracer.settings import RenderSettings, WorkingColorSpace
    from metal_pathtracer.utils.procgen import dragon_class_scene_mesh

    settings = RenderSettings()
    settings.maxDepth = 2
    settings.workingColorSpace = WorkingColorSpace.ACESCG
    res = SceneResources()
    res.add_material(Material())
    src = dragon_class_scene_mesh(1, material=0)
    m = np.eye(4)
    m[:3, :3] = [[0.0, 0.0, 1.2], [0.0, 1.0, 0.0], [-0.8, 0.0, 0.0]]
    res.add_mesh_instance(src, m)
    res.add_mesh(src)
    scene = res.build_arrays(traversal="xla")
    static = settings_to_static(settings, 8, 8, res.material_types_present())
    uni = settings_to_uniforms(settings, build_camera(settings, 8, 8), 0, 0)
    return scene, uni, RenderState.create(8, 8), static


def test_integrator_contractions_are_highest():
    from metal_pathtracer.renderer.frame import render_rows

    scene, uni, state, static = _instanced_acescg()
    found = _all_highest(
        lambda sc, u, st: render_rows(sc, u, st, static, 1, 0), scene, uni,
        state)
    # the ACEScg working-space matrix is one of them
    assert found


@pytest.mark.parametrize("which", ["aces_tonemap", "denoise_mlp",
                                   "denoise_unet"])
def test_display_path_contractions_are_highest(which):
    img = jnp.full((8, 8, 3), 0.5, jnp.float32)
    if which == "aces_tonemap":
        from metal_pathtracer.ops.tonemap import aces_fitted
        found = _all_highest(aces_fitted, img)
    elif which == "denoise_mlp":
        from metal_pathtracer.ops import denoise
        params = denoise._learned_params()
        assert params is not None
        f = jnp.zeros((8, params["w1"].shape[0]), jnp.float32)
        found = _all_highest(lambda f_: denoise._mlp_logit(params, f_), f)
    else:
        from metal_pathtracer.ops import denoise_unet
        params = denoise_unet.init_params(jax.random.PRNGKey(0))
        found = _all_highest(
            lambda c: denoise_unet.denoise(c, c, c, c, params, c), img)
    assert found


def test_instance_transform_is_full_float32():
    """The world->object transform must not round like TF32: compare with
    a float64 reference at 1e-6 relative."""
    from metal_pathtracer.ops.traversal import _transform_point

    rng = np.random.default_rng(0)
    m = rng.normal(size=(3, 4)).astype(np.float32)
    p = rng.uniform(-100, 100, (64, 3)).astype(np.float32)
    got = np.asarray(jax.jit(_transform_point)(jnp.asarray(m),
                                               jnp.asarray(p)))
    want = p.astype(np.float64) @ m[:, :3].T.astype(np.float64) + m[:, 3]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)
