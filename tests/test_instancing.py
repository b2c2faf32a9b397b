"""True mesh instancing: one shared object-space BLAS per source with
per-instance transforms (reference: SceneAccel.mm SoftwareInstanceInfo
:173-247) vs the baked world-space-soup path."""

import numpy as np
import pytest

from metal_pathtracer.ops.camera import build_camera
from metal_pathtracer.renderer import frame
from metal_pathtracer.renderer.accumulation import RenderState
from metal_pathtracer.scene.resources import Material, Mesh, SceneResources
from metal_pathtracer.schema import settings_to_static, settings_to_uniforms
from metal_pathtracer.settings import RenderSettings
from metal_pathtracer.utils.procgen import dragon_class_mesh


def _source_mesh(material=0):
    pos, normals, faces = dragon_class_mesh(2)
    uv = np.zeros((len(pos), 2), np.float32)
    return Mesh(name="blob", vertices=pos, normals=normals, uv0=uv,
                uv1=uv.copy(), tangents=np.zeros((len(pos), 4), np.float32),
                indices=faces, material=material)


def _transforms():
    import math
    out = []
    for i, (tx, s, ry) in enumerate([(-2.2, 0.8, 0.3), (0.0, 1.0, 0.0),
                                     (2.3, 1.25, -0.7)]):
        c, sn = math.cos(ry), math.sin(ry)
        m = np.eye(4)
        m[:3, :3] = np.array([[c, 0, sn], [0, 1, 0], [-sn, 0, c]]) * s
        m[:3, 3] = [tx, 0.15 * i, 0.0]
        out.append(m)
    return out


def _settings():
    s = RenderSettings()
    s.cameraTarget = (0.0, 0.0, 0.0)
    s.cameraDistance = 7.0
    s.cameraPitch = 0.35
    s.maxDepth = 4
    s.fixedRngSeed = 55
    return s


def _render(res, settings, w=48, h=28, spp=2):
    scene = res.build_arrays()
    static = settings_to_static(settings, w, h,
                                res.material_types_present())
    uni = settings_to_uniforms(settings, build_camera(settings, w, h), 0, 0)
    st = frame.render_samples(scene, uni, RenderState.create(w, h),
                              static, spp)
    return np.asarray(st.present())[..., :3], scene


def test_instanced_matches_baked():
    settings = _settings()
    src = _source_mesh()

    baked = SceneResources()
    baked.add_material(Material(base_color=(0.7, 0.6, 0.5)))
    for m in _transforms():
        inv_t = np.linalg.inv(m)[:3, :3].T
        v = (src.vertices @ m[:3, :3].T) + m[:3, 3]
        n = src.normals @ np.linalg.inv(m)[:3, :3]
        n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-20)
        baked.add_mesh(Mesh(
            name="b", vertices=v.astype(np.float32),
            normals=n.astype(np.float32), uv0=src.uv0, uv1=src.uv1,
            tangents=src.tangents, indices=src.indices, material=0))

    inst = SceneResources()
    inst.add_material(Material(base_color=(0.7, 0.6, 0.5)))
    for m in _transforms():
        inst.add_mesh_instance(src, m, material=0)

    img_b, scene_b = _render(baked, settings)
    img_i, scene_i = _render(inst, settings)

    # ~1x triangle memory: the instanced scene stores the source ONCE
    assert len(scene_i.instanced) == 1
    group = scene_i.instanced[0]
    assert group.count == 3
    assert group.triangles.count == len(src.indices)
    assert scene_b.triangles.count == 3 * len(src.indices)
    assert scene_i.triangles is None  # no baked soup at all

    d = np.abs(img_i - img_b)
    rmse = float(np.sqrt((d * d).mean()))
    assert rmse < 2e-3, (rmse, float(d.max()))
    assert img_i.mean() > 0.05  # actually rendered something


def test_instanced_self_hit_exclusion_and_shadows():
    """Bounces between instances: exclusion ids are global, so a bounce
    off instance 0 can still hit tri k of instance 1."""
    settings = _settings()
    settings.maxDepth = 5
    src = _source_mesh()
    res = SceneResources()
    res.add_material(Material(base_color=(0.8, 0.8, 0.8)))
    m1 = np.eye(4)
    m1[:3, 3] = [-1.3, 0, 0]
    m2 = np.eye(4)
    m2[:3, 3] = [1.3, 0, 0]
    res.add_mesh_instance(src, m1, 0)
    res.add_mesh_instance(src, m2, 0)
    img, scene = _render(res, settings)
    assert np.isfinite(img).all()
    assert img.mean() > 0.05


def test_instanced_dsl_token(tmp_path):
    from metal_pathtracer.scene import dsl
    from metal_pathtracer.scene.meshload import mesh_loader

    obj = tmp_path / "tri.obj"
    obj.write_text("v -1 0 -1\nv 1 0 -1\nv 0 1 -1\nf 1 2 3\n")
    text = f"""\
camera target=0,0,-1 distance=3 yaw=0 pitch=0 vfov=45
material type=lambert albedo=0.8,0.2,0.2
mesh path={obj} material=0 instanced=1 translate=-0.8,0,0
mesh path={obj} material=0 instanced=1 translate=0.8,0,0 scale=0.5
"""
    settings = RenderSettings()
    res = SceneResources()
    dsl.parse_scene(text, settings, res, scene_directory=str(tmp_path),
                    mesh_loader=mesh_loader)
    assert len(res.mesh_instances) == 2
    assert res.mesh_instances[0].source is res.mesh_instances[1].source
    scene = res.build_arrays()
    assert len(scene.instanced) == 1
    assert scene.instanced[0].count == 2


@pytest.mark.skipif(
    not __import__("metal_pathtracer.renderer.oracle",
                   fromlist=["oracle_available"]).oracle_available(),
    reason="native oracle not built")
def test_instanced_matches_oracle():
    """Cross-implementation gate: the instanced JAX path vs the oracle
    (which bakes instances into world space independently)."""
    from metal_pathtracer.renderer import oracle

    settings = _settings()
    src = _source_mesh()
    res = SceneResources()
    res.add_material(Material(base_color=(0.7, 0.6, 0.5)))
    for m in _transforms():
        res.add_mesh_instance(src, m, material=0)
    w, h, spp = 40, 24, 32
    img_jax, _ = _render(res, settings, w, h, spp)
    img_oracle = oracle.render_oracle(res, settings, w, h, spp)
    err = oracle.rmse(img_jax, img_oracle[..., :3])
    assert err < 0.01, f"instanced RMSE {err}"
