"""The pytree dataclasses (utils/pytree.py): every class round-trips
through flatten/unflatten, and its static fields stay out of the leaves."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from metal_pathtracer import schema
from metal_pathtracer.ops import bsdf, intersect, textures
from metal_pathtracer.renderer import accumulation
from metal_pathtracer.utils import pytree


def _scene():
    from metal_pathtracer.scene.resources import Material, SceneResources
    from metal_pathtracer.utils.procgen import dragon_class_scene_mesh

    res = SceneResources()
    res.add_material(Material())
    res.add_mesh(dragon_class_scene_mesh(1, material=0))
    res.add_mesh_instance(res.meshes[0], np.eye(4))
    res.texture_images.append(np.full((4, 4, 4), 200, np.uint8))
    res.texture_srgb.append(True)
    return res.build_arrays(traversal="interpret")


def _env():
    from metal_pathtracer.ops import env as env_ops
    return env_ops.environment_from_texels(
        jnp.full((8, 16, 3), 0.5, jnp.float32))


def _static():
    from metal_pathtracer.settings import RenderSettings
    return schema.settings_to_static(RenderSettings(), 8, 8, (0,))


def _uniforms():
    from metal_pathtracer.ops.camera import build_camera
    from metal_pathtracer.settings import RenderSettings
    s = RenderSettings()
    return schema.settings_to_uniforms(s, build_camera(s, 8, 8), 0, 0)


def _lanes(cls, n=4):
    """An instance of a per-lane record class with zero leaves."""
    kw = {f.name: jnp.zeros((n,), jnp.float32)
          for f in dataclasses.fields(cls)}
    return cls(**kw)


CASES = {
    "MaterialsSoA": lambda: _scene().materials,
    "SpheresSoA": lambda: _scene().spheres,
    "RectsSoA": lambda: _scene().rects,
    "BvhSoA": lambda: _scene().tri_bvh,
    "TraversalTables": lambda: _scene().tri_kernel,
    "TrianglesSoA": lambda: _scene().triangles,
    "EnvironmentSoA": _env,
    "SceneArrays": _scene,
    "InstanceGroup": lambda: _scene().instanced[0],
    "TextureArrays": lambda: _scene().textures,
    "CameraUniforms": lambda: _uniforms().camera,
    "Uniforms": _uniforms,
    "StaticConfig": _static,
    "RenderState": lambda: accumulation.RenderState.create(4, 2),
    "HitRecord": lambda: intersect.HitRecord.miss((4,)),
    "BsdfSample": lambda: bsdf.BsdfSample.invalid((4,)),
    "MatLanes": lambda: _lanes(bsdf.MatLanes),
}

STATIC = {
    "EnvironmentSoA": {"width", "height", "mip_meta"},
    "TraversalTables": {"block", "interpret"},
    "InstanceGroup": {"base_id", "count"},
    "TextureArrays": {"n_textures", "max_levels"},
}


def _static_names(cls):
    return {f.name for f in dataclasses.fields(cls)
            if f.metadata.get(pytree._STATIC)}


@pytest.mark.parametrize("name", sorted(CASES))
def test_round_trip_and_static_fields(name):
    obj = CASES[name]()
    cls = type(obj)
    assert cls.__name__ == name
    leaves, treedef = jax.tree_util.tree_flatten(obj)
    back = jax.tree_util.tree_unflatten(treedef, leaves)
    assert type(back) is cls
    for a, b in zip(leaves, jax.tree_util.tree_leaves(back)):
        assert a is b
    static = _static_names(cls)
    assert static == STATIC.get(name, set())
    for f in static:
        # static values live in the treedef, never among the leaves
        assert getattr(back, f) == getattr(obj, f)
        assert all(x is not getattr(obj, f) for x in leaves)
    # frozen, with a working .replace
    f0 = dataclasses.fields(cls)[0].name
    with pytest.raises(dataclasses.FrozenInstanceError):
        setattr(obj, f0, None)
    assert getattr(obj.replace(**{f0: getattr(obj, f0)}), f0) is \
        getattr(obj, f0)


def test_static_field_change_changes_treedef():
    tables = CASES["TraversalTables"]()
    a = jax.tree_util.tree_structure(tables)
    b = jax.tree_util.tree_structure(tables.replace(block=64))
    assert a != b
