"""glTF 2.0 / GLB loader.

Dependency-free port of the reference's loader
(reference: src/assets/GltfLoader.mm, include/assets/GltfLoader.h:11-42):
GLB chunk parsing, buffers/views/accessors including base64 data URIs,
node-hierarchy TRS composition, PBR metallic-roughness materials with
KHR_materials_transmission / KHR_materials_volume / KHR_texture_transform,
per-slot UV sets, alpha modes, double-sided, emissive scale, and camera
nodes. Images decode through PIL into SceneResources.texture_images.
"""

from __future__ import annotations

import base64
import json
import os
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from metal_pathtracer import constants as C
from metal_pathtracer.scene.resources import Material, Mesh, SceneResources

_COMPONENT_DTYPES = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16,
    5123: np.uint16, 5125: np.uint32, 5126: np.float32,
}
_TYPE_COUNTS = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4,
                "MAT2": 4, "MAT3": 9, "MAT4": 16}

# texture slot order in MaterialsSoA.texture_indices:
SLOT_BASE, SLOT_MR, SLOT_NORMAL, SLOT_OCCLUSION, SLOT_EMISSIVE, SLOT_TRANSMISSION = range(6)


class GltfError(ValueError):
    pass


def _load_glb(data: bytes):
    """(reference: GltfLoader.mm GLB chunk parse :812-857)"""
    magic, version, _length = struct.unpack_from("<III", data, 0)
    if magic != 0x46546C67:
        raise GltfError("not a GLB file")
    if version != 2:
        raise GltfError(f"unsupported GLB version {version}")
    offset = 12
    gltf_json = None
    bin_chunk = None
    while offset + 8 <= len(data):
        chunk_len, chunk_type = struct.unpack_from("<II", data, offset)
        offset += 8
        chunk = data[offset:offset + chunk_len]
        offset += chunk_len
        if chunk_type == 0x4E4F534A:  # JSON
            gltf_json = json.loads(chunk.decode("utf-8"))
        elif chunk_type == 0x004E4942:  # BIN
            bin_chunk = chunk
    if gltf_json is None:
        raise GltfError("GLB missing JSON chunk")
    return gltf_json, bin_chunk


class GltfFile:
    def __init__(self, path: str):
        self.base_dir = os.path.dirname(os.path.abspath(path))
        with open(path, "rb") as f:
            raw = f.read()
        if path.lower().endswith(".glb") or raw[:4] == b"glTF":
            self.doc, self.bin_chunk = _load_glb(raw)
        else:
            self.doc = json.loads(raw.decode("utf-8"))
            self.bin_chunk = None
        self._buffers: Dict[int, bytes] = {}

    # -- low-level access ---------------------------------------------------

    def buffer(self, index: int) -> bytes:
        """(reference: GltfLoader.mm buffers incl. data URIs :173-199)"""
        if index in self._buffers:
            return self._buffers[index]
        spec = self.doc["buffers"][index]
        uri = spec.get("uri")
        if uri is None:
            if self.bin_chunk is None:
                raise GltfError("buffer refers to missing GLB BIN chunk")
            data = self.bin_chunk
        elif uri.startswith("data:"):
            b64 = uri.split(",", 1)[1]
            data = base64.b64decode(b64)
        else:
            from urllib.parse import unquote
            with open(os.path.join(self.base_dir, unquote(uri)), "rb") as f:
                data = f.read()
        self._buffers[index] = data
        return data

    def accessor(self, index: int) -> np.ndarray:
        """Decode accessor -> (count, components) array, dequantized
        (reference: GltfLoader.mm accessors :359-513)."""
        acc = self.doc["accessors"][index]
        count = acc["count"]
        n_comp = _TYPE_COUNTS[acc["type"]]
        dtype = _COMPONENT_DTYPES[acc["componentType"]]
        itemsize = np.dtype(dtype).itemsize

        if "bufferView" not in acc:
            out = np.zeros((count, n_comp), dtype)
        else:
            view = self.doc["bufferViews"][acc["bufferView"]]
            data = self.buffer(view["buffer"])
            start = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
            stride = view.get("byteStride") or n_comp * itemsize
            if stride == n_comp * itemsize:
                out = np.frombuffer(data, dtype, count * n_comp,
                                    start).reshape(count, n_comp).copy()
            else:
                raw = np.frombuffer(data, np.uint8)
                rows = np.zeros((count, n_comp), dtype)
                for i in range(n_comp):
                    off = start + i * itemsize
                    idx = off + np.arange(count) * stride
                    rows[:, i] = np.frombuffer(
                        raw, dtype, count,
                        0)[0:0].dtype.type(0) if False else \
                        raw.view(np.uint8)[0:0].sum()  # placeholder
                # general strided decode
                for r in range(count):
                    rows[r] = np.frombuffer(
                        data, dtype, n_comp, start + r * stride)
                out = rows

        # sparse accessors
        sparse = acc.get("sparse")
        if sparse:
            sc = sparse["count"]
            iview = self.doc["bufferViews"][sparse["indices"]["bufferView"]]
            idtype = _COMPONENT_DTYPES[sparse["indices"]["componentType"]]
            idata = self.buffer(iview["buffer"])
            ioff = iview.get("byteOffset", 0) + sparse["indices"].get("byteOffset", 0)
            indices = np.frombuffer(idata, idtype, sc, ioff)
            vview = self.doc["bufferViews"][sparse["values"]["bufferView"]]
            vdata = self.buffer(vview["buffer"])
            voff = vview.get("byteOffset", 0) + sparse["values"].get("byteOffset", 0)
            values = np.frombuffer(vdata, dtype, sc * n_comp,
                                   voff).reshape(sc, n_comp)
            out[indices] = values

        if acc.get("normalized") and dtype != np.float32:
            info = np.iinfo(dtype)
            out = out.astype(np.float32) / float(info.max)
            if info.min < 0:
                out = np.maximum(out, -1.0)
        return out

    def image_bytes(self, index: int) -> Tuple[bytes, str]:
        img = self.doc["images"][index]
        if "uri" in img:
            uri = img["uri"]
            if uri.startswith("data:"):
                return base64.b64decode(uri.split(",", 1)[1]), img.get("mimeType", "")
            from urllib.parse import unquote
            with open(os.path.join(self.base_dir, unquote(uri)), "rb") as f:
                return f.read(), img.get("mimeType", "")
        view = self.doc["bufferViews"][img["bufferView"]]
        data = self.buffer(view["buffer"])
        start = view.get("byteOffset", 0)
        return data[start:start + view["byteLength"]], img.get("mimeType", "")


def _node_matrix(node: dict) -> np.ndarray:
    """(reference: GltfLoader.mm node TRS :219-269)"""
    if "matrix" in node:
        return np.asarray(node["matrix"], np.float64).reshape(4, 4).T
    t = node.get("translation", [0, 0, 0])
    r = node.get("rotation", [0, 0, 0, 1])  # xyzw
    s = node.get("scale", [1, 1, 1])
    x, y, z, w = r
    rot = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])
    m = np.eye(4)
    m[:3, :3] = rot @ np.diag(s)
    m[:3, 3] = t
    return m


def _tex_transform(ext: Optional[dict]) -> np.ndarray:
    """KHR_texture_transform -> 2x3 affine rows
    (reference: GltfLoader.mm :323-350, 615-632)."""
    m = np.zeros((2, 3), np.float32)
    m[0, 0] = 1.0
    m[1, 1] = 1.0
    if not ext:
        return m
    offset = ext.get("offset", [0.0, 0.0])
    rotation = ext.get("rotation", 0.0)
    scale = ext.get("scale", [1.0, 1.0])
    cos_r = np.cos(rotation)
    sin_r = np.sin(rotation)
    # uv' = offset + R(-rotation) * S * uv (glTF spec ordering)
    m[0, 0] = cos_r * scale[0]
    m[0, 1] = sin_r * scale[1]
    m[0, 2] = offset[0]
    m[1, 0] = -sin_r * scale[0]
    m[1, 1] = cos_r * scale[1]
    m[1, 2] = offset[1]
    return m


def _decode_image(data: bytes) -> np.ndarray:
    """-> (H,W,4) uint8 RGBA"""
    import io
    try:
        from PIL import Image
    except ImportError as exc:
        raise ImportError("decoding glTF PNG/JPEG textures needs the "
                          "Pillow package") from exc

    img = Image.open(io.BytesIO(data)).convert("RGBA")
    return np.asarray(img, np.uint8)


def load_gltf_into(path: str, settings, resources: SceneResources,
                   root_transform: np.ndarray,
                   allow_camera_import: bool = False,
                   tokens: Optional[dict] = None) -> None:
    """Load a glTF/GLB file's default scene into SceneResources.

    Per-primitive materials become PBR materials; textures are decoded and
    registered in resources.texture_images with per-slot color-space flags
    (reference: GltfLoader.mm PBR conversion :650-791).
    """
    gltf = GltfFile(path)
    doc = gltf.doc
    tokens = tokens or {}

    emissive_scale = getattr(settings, "gltfEmissiveScale", 1.0)
    thin_fallback = getattr(settings, "gltfThinWalledFallback", True)

    # --- textures ----------------------------------------------------------
    texture_cache: Dict[Tuple[int, bool], int] = {}

    def load_texture(tex_index: int, srgb: bool) -> Tuple[int, int, int]:
        """-> (global texture id, wrap_s, wrap_t)"""
        tex = doc["textures"][tex_index]
        sampler = doc.get("samplers", [{}])[tex.get("sampler", 0)] \
            if doc.get("samplers") else {}
        wrap_s = sampler.get("wrapS", 10497)
        wrap_t = sampler.get("wrapT", 10497)
        key = (tex["source"], srgb)
        if key not in texture_cache:
            pixels = _decode_image(gltf.image_bytes(tex["source"])[0])
            resources.texture_images.append(pixels)
            resources.texture_srgb.append(srgb)
            wrap_map = {10497: 0, 33071: 1, 33648: 2}
            resources.texture_wrap.append((wrap_map.get(wrap_s, 0),
                                           wrap_map.get(wrap_t, 0)))
            texture_cache[key] = len(resources.texture_images) - 1
        return texture_cache[key], wrap_s, wrap_t

    # --- materials ---------------------------------------------------------
    material_map: Dict[int, int] = {}

    def convert_material(mi: Optional[int]) -> int:
        key = -1 if mi is None else mi
        if key in material_map:
            return material_map[key]
        spec = doc.get("materials", [])[mi] if mi is not None else {}
        pbr = spec.get("pbrMetallicRoughness", {})
        ext = spec.get("extensions", {})

        base_factor = pbr.get("baseColorFactor", [1, 1, 1, 1])
        metallic = pbr.get("metallicFactor", 1.0)
        roughness = pbr.get("roughnessFactor", 1.0)
        emissive = spec.get("emissiveFactor", [0, 0, 0])
        strength = ext.get("KHR_materials_emissive_strength", {}).get(
            "emissiveStrength", 1.0)
        emissive = [e * strength * emissive_scale for e in emissive]

        transmission = ext.get("KHR_materials_transmission", {}).get(
            "transmissionFactor", 0.0)
        volume = ext.get("KHR_materials_volume", {})
        thickness = volume.get("thicknessFactor", 0.0)
        sigma_a = (0.0, 0.0, 0.0)
        if volume:
            att_dist = volume.get("attenuationDistance", 0.0)
            att_color = volume.get("attenuationColor", [1, 1, 1])
            if att_dist > 0.0:
                # sigma_a = -ln(color)/distance (reference :599-614)
                sigma_a = tuple(
                    max(-np.log(max(c, 1e-4)) / att_dist, 0.0)
                    for c in att_color)
        thin = transmission > 0.0 and thickness <= 0.0 and thin_fallback
        ior = ext.get("KHR_materials_ior", {}).get("ior", 1.5)

        tex_idx = [-1] * 6
        uv_set = [0] * 6
        transforms = np.zeros((6, 2, 3), np.float32)
        transforms[:, 0, 0] = 1.0
        transforms[:, 1, 1] = 1.0

        def wire(slot, info, srgb):
            if not info:
                return
            tid, _ws, _wt = load_texture(info["index"], srgb)
            tex_idx[slot] = tid
            uv_set[slot] = info.get("texCoord", 0)
            transforms[slot] = _tex_transform(
                info.get("extensions", {}).get("KHR_texture_transform"))

        force_linear_base = getattr(settings, "gltfCompatForceLinearBaseColor", False)
        force_linear_emissive = getattr(settings, "gltfCompatForceLinearEmissive", False)
        wire(SLOT_BASE, pbr.get("baseColorTexture"), not force_linear_base)
        wire(SLOT_MR, pbr.get("metallicRoughnessTexture"), False)
        wire(SLOT_NORMAL, spec.get("normalTexture"), False)
        wire(SLOT_OCCLUSION, spec.get("occlusionTexture"), False)
        wire(SLOT_EMISSIVE, spec.get("emissiveTexture"),
             not force_linear_emissive)
        wire(SLOT_TRANSMISSION,
             ext.get("KHR_materials_transmission", {}).get("transmissionTexture"),
             False)

        alpha_mode = {"OPAQUE": 0, "MASK": 1, "BLEND": 2}.get(
            spec.get("alphaMode", "OPAQUE"), 0)

        mat = Material(
            base_color=tuple(base_factor[:3]),
            roughness=roughness,
            mat_type=C.MATERIAL_PBR,
            ior=ior,
            emission=tuple(emissive),
            dielectric_sigma_a=sigma_a,
            thin=thin,
            name=spec.get("name", f"gltf_mat_{key}"),
            pbr_metallic=metallic,
            pbr_roughness=roughness,
            pbr_occlusion_strength=(spec.get("occlusionTexture") or {}).get(
                "strength", 1.0),
            pbr_normal_scale=(spec.get("normalTexture") or {}).get("scale", 1.0),
            pbr_alpha=base_factor[3] if len(base_factor) > 3 else 1.0,
            pbr_alpha_cutoff=spec.get("alphaCutoff", 0.5),
            pbr_transmission=transmission,
            pbr_alpha_mode=alpha_mode,
            pbr_double_sided=spec.get("doubleSided", False),
            pbr_thickness=thickness,
            texture_indices=tuple(tex_idx),
            texture_uv_set=tuple(uv_set),
            texture_transform=transforms,
        )
        material_map[key] = resources.add_material(mat)
        return material_map[key]

    # --- nodes / meshes ----------------------------------------------------
    scene_index = doc.get("scene", 0)
    scenes = doc.get("scenes", [{"nodes": list(range(len(doc.get("nodes", []))))}])
    root_nodes = scenes[scene_index].get("nodes", [])

    camera_info = {}

    def walk(node_index: int, parent: np.ndarray):
        node = doc["nodes"][node_index]
        world = parent @ _node_matrix(node)
        if "mesh" in node:
            emit_mesh(doc["meshes"][node["mesh"]], world,
                      node.get("name", f"node{node_index}"))
        if "camera" in node and allow_camera_import and not camera_info:
            camera_info["matrix"] = world
            camera_info["camera"] = doc["cameras"][node["camera"]]
        for child in node.get("children", []):
            walk(child, world)

    def emit_mesh(mesh_spec: dict, world: np.ndarray, name: str):
        normal_mat = np.linalg.inv(world[:3, :3]).T
        for prim in mesh_spec.get("primitives", []):
            if prim.get("mode", 4) != 4:  # triangles only
                continue
            attrs = prim["attributes"]
            pos = gltf.accessor(attrs["POSITION"]).astype(np.float32)
            n_verts = len(pos)
            normals = gltf.accessor(attrs["NORMAL"]).astype(np.float32) \
                if "NORMAL" in attrs else np.zeros_like(pos)
            uv0 = gltf.accessor(attrs["TEXCOORD_0"]).astype(np.float32) \
                if "TEXCOORD_0" in attrs else np.zeros((n_verts, 2), np.float32)
            uv1 = gltf.accessor(attrs["TEXCOORD_1"]).astype(np.float32) \
                if "TEXCOORD_1" in attrs else np.zeros((n_verts, 2), np.float32)
            tangents = gltf.accessor(attrs["TANGENT"]).astype(np.float32) \
                if "TANGENT" in attrs else np.zeros((n_verts, 4), np.float32)

            if "indices" in prim:
                idx = gltf.accessor(prim["indices"]).reshape(-1).astype(np.int64)
            else:
                idx = np.arange(n_verts, dtype=np.int64)
            faces = idx.reshape(-1, 3).astype(np.int32)

            # to world space
            wpos = (pos @ world[:3, :3].T + world[:3, 3]).astype(np.float32)
            wnrm = normals @ normal_mat.T
            ln = np.linalg.norm(wnrm, axis=-1, keepdims=True)
            wnrm = np.where(ln > 0, wnrm / np.maximum(ln, 1e-20), wnrm).astype(np.float32)
            wtan = tangents.copy()
            wtan[:, :3] = tangents[:, :3] @ world[:3, :3].T
            tl = np.linalg.norm(wtan[:, :3], axis=-1, keepdims=True)
            wtan[:, :3] = np.where(tl > 0, wtan[:, :3] / np.maximum(tl, 1e-20),
                                   wtan[:, :3])

            material = convert_material(prim.get("material"))
            if np.linalg.norm(normals).sum() == 0:
                # flat-normal fallback (reference: ApplyFallbackNormals)
                e1 = wpos[faces[:, 1]] - wpos[faces[:, 0]]
                e2 = wpos[faces[:, 2]] - wpos[faces[:, 0]]
                fn = np.cross(e1, e2)
                for c in range(3):
                    np.add.at(wnrm, faces[:, c], fn)
                l2 = np.linalg.norm(wnrm, axis=-1, keepdims=True)
                wnrm = np.where(l2 > 0, wnrm / np.maximum(l2, 1e-20), wnrm)
            if np.abs(tangents).sum() == 0 and np.abs(uv0).sum() != 0:
                from metal_pathtracer.scene.tangent import generate_tangents
                wtan = generate_tangents(wpos, wnrm.astype(np.float32),
                                         uv0, faces)

            resources.add_mesh(Mesh(
                name=name, vertices=wpos, normals=wnrm.astype(np.float32),
                uv0=uv0, uv1=uv1, tangents=wtan.astype(np.float32),
                indices=faces, material=material))

    for root in root_nodes:
        walk(root, root_transform.astype(np.float64))

    # --- camera import (reference: GltfCameraInfo, GltfLoader.h:11-23) ----
    if camera_info and allow_camera_import:
        m = camera_info["matrix"]
        cam = camera_info["camera"]
        if cam.get("type") == "perspective":
            eye = m[:3, 3]
            forward = -m[:3, 2]
            # aim at scene center approximated by mesh bounds
            if resources.meshes:
                lo = np.min([me.vertices.min(0) for me in resources.meshes], 0)
                hi = np.max([me.vertices.max(0) for me in resources.meshes], 0)
                target = (lo + hi) / 2
            else:
                target = eye + forward
            offset = eye - target
            dist = float(np.linalg.norm(offset))
            settings.cameraTarget = tuple(float(v) for v in target)
            settings.cameraDistance = max(dist, 0.1)
            settings.cameraYaw = float(np.arctan2(offset[2], offset[0]))
            settings.cameraPitch = float(np.arcsin(
                np.clip(offset[1] / max(dist, 1e-6), -1, 1)))
            settings.cameraVerticalFov = float(np.degrees(
                cam["perspective"].get("yfov", 0.8)))
