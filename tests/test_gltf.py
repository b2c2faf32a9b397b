"""glTF 2.0 loader + texture pipeline tests
(reference: src/assets/GltfLoader.mm)."""

import base64
import io
import json
import struct

import numpy as np
import pytest

from metal_pathtracer.scene.gltf import GltfFile, load_gltf_into
from metal_pathtracer.scene.resources import SceneResources
from metal_pathtracer.settings import RenderSettings
from metal_pathtracer import constants as C


def _png_bytes(rgba: np.ndarray) -> bytes:
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(rgba, "RGBA").save(buf, "PNG")
    return buf.getvalue()


def make_quad_glb(tmp_path, with_texture=False, alpha_mode=None,
                  transmission=None, emissive=None):
    """Two-triangle unit quad in the XY plane with a PBR material."""
    positions = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float32)
    normals = np.array([[0, 0, 1]] * 4, np.float32)
    uvs = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    indices = np.array([0, 1, 2, 0, 2, 3], np.uint16)

    bin_data = b""
    views = []
    accessors = []

    def add(data, target, comp_type, acc_type, count, extra=None):
        nonlocal bin_data
        offset = len(bin_data)
        bin_data += data
        if len(bin_data) % 4:
            bin_data += b"\x00" * (4 - len(bin_data) % 4)
        views.append({"buffer": 0, "byteOffset": offset, "byteLength": len(data)})
        acc = {"bufferView": len(views) - 1, "componentType": comp_type,
               "type": acc_type, "count": count}
        if extra:
            acc.update(extra)
        accessors.append(acc)
        return len(accessors) - 1

    pos_acc = add(positions.tobytes(), 34962, 5126, "VEC3", 4,
                  {"min": positions.min(0).tolist(),
                   "max": positions.max(0).tolist()})
    nrm_acc = add(normals.tobytes(), 34962, 5126, "VEC3", 4)
    uv_acc = add(uvs.tobytes(), 34962, 5126, "VEC2", 4)
    idx_acc = add(indices.tobytes(), 34963, 5123, "SCALAR", 6)

    material = {"pbrMetallicRoughness": {
        "baseColorFactor": [1.0, 0.5, 0.25, 1.0],
        "metallicFactor": 0.0, "roughnessFactor": 0.8}}
    doc = {
        "asset": {"version": "2.0"},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0, "translation": [1.0, 0.0, 0.0]}],
        "meshes": [{"primitives": [{
            "attributes": {"POSITION": pos_acc, "NORMAL": nrm_acc,
                           "TEXCOORD_0": uv_acc},
            "indices": idx_acc, "material": 0}]}],
        "materials": [material],
        "buffers": [{"byteLength": len(bin_data)}],
        "bufferViews": views,
        "accessors": accessors,
    }
    if with_texture:
        rgba = np.zeros((8, 8, 4), np.uint8)
        rgba[:, :4] = (255, 0, 0, 255)
        rgba[:, 4:] = (0, 255, 0, 255)
        png = _png_bytes(rgba)
        img_offset = len(bin_data)
        bin_data += png
        if len(bin_data) % 4:
            bin_data += b"\x00" * (4 - len(bin_data) % 4)
        doc["bufferViews"].append({"buffer": 0, "byteOffset": img_offset,
                                   "byteLength": len(png)})
        doc["images"] = [{"bufferView": len(doc["bufferViews"]) - 1,
                          "mimeType": "image/png"}]
        doc["samplers"] = [{"wrapS": 33071, "wrapT": 10497}]
        doc["textures"] = [{"source": 0, "sampler": 0}]
        material["pbrMetallicRoughness"]["baseColorTexture"] = {"index": 0}
    if alpha_mode:
        material["alphaMode"] = alpha_mode
        material["alphaCutoff"] = 0.5
    if transmission is not None:
        material.setdefault("extensions", {})["KHR_materials_transmission"] = {
            "transmissionFactor": transmission}
    if emissive is not None:
        material["emissiveFactor"] = emissive
    doc["buffers"][0]["byteLength"] = len(bin_data)

    json_data = json.dumps(doc).encode()
    if len(json_data) % 4:
        json_data += b" " * (4 - len(json_data) % 4)
    glb = struct.pack("<III", 0x46546C67, 2, 12 + 8 + len(json_data) + 8 + len(bin_data))
    glb += struct.pack("<II", len(json_data), 0x4E4F534A) + json_data
    glb += struct.pack("<II", len(bin_data), 0x004E4942) + bin_data
    path = tmp_path / "quad.glb"
    path.write_bytes(glb)
    return str(path)


def test_glb_parse_and_load(tmp_path):
    path = make_quad_glb(tmp_path)
    settings = RenderSettings()
    res = SceneResources()
    load_gltf_into(path, settings, res, np.eye(4))
    assert len(res.meshes) == 1
    mesh = res.meshes[0]
    assert mesh.indices.shape == (2, 3)
    # node translation applied: x in [1,2]
    assert mesh.vertices[:, 0].min() == pytest.approx(1.0)
    assert mesh.vertices[:, 0].max() == pytest.approx(2.0)
    mat = res.materials[mesh.material]
    assert mat.mat_type == C.MATERIAL_PBR
    np.testing.assert_allclose(mat.base_color, (1.0, 0.5, 0.25))
    assert mat.pbr_metallic == 0.0
    assert mat.roughness == pytest.approx(0.8)


def test_glb_texture_decode(tmp_path):
    path = make_quad_glb(tmp_path, with_texture=True)
    settings = RenderSettings()
    res = SceneResources()
    load_gltf_into(path, settings, res, np.eye(4))
    assert len(res.texture_images) == 1
    assert res.texture_srgb == [True]
    assert res.texture_wrap == [(1, 0)]
    mat = res.materials[res.meshes[0].material]
    assert mat.texture_indices[0] == 0  # base color slot wired


def test_glb_transmission_and_emissive(tmp_path):
    path = make_quad_glb(tmp_path, transmission=0.7, emissive=[2.0, 1.0, 0.5])
    settings = RenderSettings()
    settings.gltfEmissiveScale = 2.0
    res = SceneResources()
    load_gltf_into(path, settings, res, np.eye(4))
    mat = res.materials[res.meshes[0].material]
    assert mat.pbr_transmission == pytest.approx(0.7)
    np.testing.assert_allclose(mat.emission, (4.0, 2.0, 1.0))
    assert mat.thin  # transmission without volume -> thin fallback


def test_texture_arrays_and_sampling():
    import jax.numpy as jnp
    from metal_pathtracer.ops import textures as tex_ops

    img = np.zeros((16, 16, 4), np.uint8)
    img[:, :8] = (255, 0, 0, 255)
    img[:, 8:] = (0, 0, 255, 255)
    arrays = tex_ops.build_texture_arrays([img], [False], [(0, 0)], size=16)
    assert arrays.n_textures == 1
    assert arrays.max_levels == 5  # 16,8,4,2,1

    tid = jnp.zeros(4, jnp.int32)
    u = jnp.asarray([0.25, 0.75, 0.25, 0.75])
    v = jnp.asarray([0.5, 0.5, 0.5, 0.5])
    c = np.asarray(tex_ops.sample_texture(arrays, tid, u, v))
    np.testing.assert_allclose(c[0, 0], 1.0, atol=0.02)  # left = red
    np.testing.assert_allclose(c[1, 2], 1.0, atol=0.02)  # right = blue
    # top mip is the average
    c_top = np.asarray(tex_ops.sample_texture(
        arrays, tid, u, v, lod=jnp.full(4, 4.0)))
    np.testing.assert_allclose(c_top[0, 0], 0.5, atol=0.05)
    # invalid id -> white
    c_inv = np.asarray(tex_ops.sample_texture(
        arrays, jnp.full(4, -1, jnp.int32), u, v))
    np.testing.assert_allclose(c_inv, 1.0)


def test_gltf_scene_renders_textured(tmp_path):
    """End-to-end: textured glTF quad renders with the texture's colors."""
    import jax.numpy as jnp
    from metal_pathtracer.ops.camera import build_camera
    from metal_pathtracer.renderer import frame
    from metal_pathtracer.renderer.accumulation import RenderState
    from metal_pathtracer.schema import settings_to_static, settings_to_uniforms

    path = make_quad_glb(tmp_path, with_texture=True)
    settings = RenderSettings()
    res = SceneResources()
    load_gltf_into(path, settings, res, np.eye(4))
    settings.cameraTarget = (1.5, 0.5, 0.0)
    settings.cameraDistance = 2.0
    settings.cameraYaw = np.pi / 2  # +z axis looking back at the quad
    settings.cameraPitch = 0.0
    settings.cameraVerticalFov = 45.0
    settings.maxDepth = 2
    settings.fixedRngSeed = 5

    scene = res.build_arrays()
    assert scene.textures is not None
    static = settings_to_static(settings, 32, 32, res.material_types_present())
    cam = build_camera(settings, 32, 32)
    uni = settings_to_uniforms(settings, cam, 0, 0)
    st = frame.render_samples(scene, uni, RenderState.create(32, 32), static, 2)
    img = np.asarray(st.present())
    assert np.isfinite(img).all()
    # left half of the quad is red-textured, right half green; with
    # baseColorFactor (1,.5,.25) the left appears red-ish, right green-ish
    left = img[16, 8]
    right = img[16, 24]
    assert left[0] > left[1]
    assert right[1] > right[0]
