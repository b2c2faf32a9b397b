"""ctypes wrapper for the native CPU oracle (native/cpu_oracle.cpp).

The framework's independent parity backend — the role the Embree renderer
plays for the reference (SURVEY.md §3.5): every feature lands with an
RMSE-on-linear-image gate against this implementation
(reference acceptance criterion: README.md:28, paper.md:29-33 — RMSE, not
bit identity).
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

from metal_pathtracer import constants as C
from metal_pathtracer.ops.camera import build_camera
from metal_pathtracer.settings import BackgroundMode, RenderSettings

from metal_pathtracer.utils.nativebuild import ensure_built, lib_path

_LIB_PATH = lib_path("libcpu_oracle.so")


def oracle_available() -> bool:
    return ensure_built("libcpu_oracle.so") is not None


def _load():
    lib = ctypes.CDLL(_LIB_PATH)
    lib.render_oracle.restype = ctypes.c_int
    return lib


# All 8 material types are implemented faithfully by the oracle.
ORACLE_TYPES = {C.MATERIAL_LAMBERTIAN, C.MATERIAL_METAL, C.MATERIAL_DIELECTRIC,
                C.MATERIAL_DIFFUSE_LIGHT, C.MATERIAL_PLASTIC, C.MATERIAL_PBR,
                C.MATERIAL_CARPAINT, C.MATERIAL_SUBSURFACE}


def pack_materials(resources) -> np.ndarray:
    from metal_pathtracer.scene.resources import (
        compute_coat_average,
        compute_coat_sample_weight,
    )

    mats = resources.materials or []
    out = np.zeros((max(len(mats), 1), 72), np.float32)
    for i, m in enumerate(mats):
        coat_roughness = float(np.clip(m.coat_roughness, 0.0, 1.0))
        avg = compute_coat_average(max(m.coat_ior, 0.0))
        weight = compute_coat_sample_weight(m.mat_type, coat_roughness,
                                            max(m.coat_thickness, 0.0), avg)
        out[i] = [
            *np.clip(m.base_color, 0.0, 1.0),
            np.clip(m.roughness, 0.0, 1.0), m.mat_type, max(m.ior, 0.0),
            1.0 if m.thin else 0.0,
            *m.emission, 1.0 if m.emission_env else 0.0,
            *np.maximum(m.conductor_eta, 0.0), *np.maximum(m.conductor_k, 0.0),
            1.0 if m.has_conductor else 0.0,
            *np.maximum(m.dielectric_sigma_a, 0.0),
            coat_roughness, max(m.coat_thickness, 0.0), min(weight, 0.95), avg,
            *np.clip(m.coat_tint, 0.0, 1.0),
            *np.maximum(m.coat_absorption, 0.0),
            max(m.coat_ior, 0.0),
            float(np.clip(m.pbr_metallic, 0.0, 1.0)),
            float(np.clip(m.pbr_transmission, 0.0, 1.0)),
            max(m.pbr_thickness, 0.0),
            1.0 if m.pbr_double_sided else 0.0,
            # carpaint lanes, derived as in SceneResources.build_arrays
            float(np.clip(m.carpaint_base_metallic, 0.0, 1.0)),
            float(np.clip(m.carpaint_base_roughness, 0.0, 1.0)),
            max(m.carpaint_flake_scale, 1e-4),
            float(np.clip(
                np.clip(m.carpaint_flake_sample_weight, 0.0, 0.95)
                * max(np.clip(m.carpaint_flake_reflectance, 0.0, 1.0), 0.01),
                0.0, 0.95)),
            float(np.clip(m.carpaint_flake_roughness, 0.0, 1.0)),
            float(np.clip(m.carpaint_flake_anisotropy, -0.99, 0.99)),
            float(np.clip(m.carpaint_flake_normal_strength, 0.0, 1.0)),
            *(np.maximum(m.carpaint_base_eta, 0.0)
              if m.carpaint_has_base_conductor else np.zeros(3)),
            *(np.maximum(m.carpaint_base_k, 0.0)
              if m.carpaint_has_base_conductor else np.zeros(3)),
            1.0 if m.carpaint_has_base_conductor else 0.0,
            # subsurface lanes
            *np.maximum(m.sss_sigma_a, 0.0),
            *np.maximum(m.sss_sigma_s, 0.0),
            max(m.sss_mfp, 0.0),
            float(np.clip(m.sss_g, -0.99, 0.99)),
            float(m.sss_method),
            1.0 if m.sss_coat else 0.0,
            1.0 if m.sss_sigma_override else 0.0,
            # texture slot ids (ops/pbr_textures.py slot order: base, ORM,
            # normal, occlusion, emissive, transmission; -1 = none)
            *(list(m.texture_indices[:6]) + [-1.0] * (6 - len(m.texture_indices))
              if m.texture_indices else [-1.0] * 6),
            float(np.clip(m.pbr_occlusion_strength, 0.0, 1.0)),
            float(max(m.pbr_normal_scale, 0.0)),
            float(m.material_flags),
            0.0, 0.0,  # pad to 72
        ]
    return out


def render_oracle(resources, settings: RenderSettings, width: int, height: int,
                  spp: int, environment=None, n_threads: int = 0) -> np.ndarray:
    """Render with the native CPU oracle; returns linear (H,W,3)."""
    lib = _load()
    cam = build_camera(settings, width, height, to_device=False)
    cam_flat = np.concatenate([
        np.asarray(cam.origin), np.asarray(cam.lower_left),
        np.asarray(cam.horizontal), np.asarray(cam.vertical),
        np.asarray(cam.u), np.asarray(cam.v),
        [float(np.asarray(cam.lens_radius))]]).astype(np.float32)

    spheres = np.zeros((max(len(resources.spheres), 1), 4), np.float32)
    sph_mat = np.zeros(max(len(resources.spheres), 1), np.int32)
    for i, s in enumerate(resources.spheres):
        spheres[i] = [*s.center, s.radius]
        sph_mat[i] = s.material

    rects = np.zeros((max(len(resources.rects), 1), 15), np.float32)
    rect_mat = np.zeros(max(len(resources.rects), 1), np.int32)
    rect_two = np.zeros(max(len(resources.rects), 1), np.int32)
    for i, r in enumerate(resources.rects):
        eu2 = float(np.dot(r.edge_u, r.edge_u))
        ev2 = float(np.dot(r.edge_v, r.edge_v))
        rects[i] = [*r.corner, *r.edge_u, *r.edge_v,
                    1.0 / max(eu2, 1e-20), 1.0 / max(ev2, 1e-20),
                    *r.normal, float(np.dot(r.normal, r.corner))]
        rect_mat[i] = r.material
        rect_two[i] = 1 if r.two_sided else 0

    tris_list = []
    tri_mat_list = []
    tri_uv_list = []
    tri_tan_list = []
    # the oracle is the scalar parity backend: bake instanced placements
    # into world space here (memory is irrelevant at gate scales)
    baked = list(resources.meshes)
    for inst in getattr(resources, "mesh_instances", []):
        src = inst.source
        m44 = np.asarray(inst.transform, np.float64)
        inv_t = np.linalg.inv(m44)[:3, :3].T
        v = (src.vertices @ m44[:3, :3].T) + m44[:3, 3]
        n = src.normals @ inv_t.T
        ln = np.linalg.norm(n, axis=1, keepdims=True)
        n = n / np.maximum(ln, 1e-20)
        from metal_pathtracer.scene.resources import Mesh as _Mesh
        baked.append(_Mesh(
            name=src.name + "-inst", vertices=v.astype(np.float32),
            normals=n.astype(np.float32), uv0=src.uv0, uv1=src.uv1,
            tangents=src.tangents, indices=src.indices,
            material=inst.material))
    for mesh in baked:
        idx = mesh.indices
        v = mesh.vertices
        t9 = np.concatenate([v[idx[:, 0]], v[idx[:, 1]], v[idx[:, 2]]], 1)
        tris_list.append(t9)
        tri_mat_list.append(np.full(len(idx), mesh.material, np.int32))
        uv = mesh.uv0 if mesh.uv0 is not None and len(mesh.uv0) == len(v) \
            else np.zeros((len(v), 2), np.float32)
        tri_uv_list.append(np.concatenate(
            [uv[idx[:, 0]], uv[idx[:, 1]], uv[idx[:, 2]]], 1))
        tan = mesh.tangents if mesh.tangents is not None \
            and len(mesh.tangents) == len(v) \
            else np.zeros((len(v), 4), np.float32)
        tri_tan_list.append(np.concatenate(
            [tan[idx[:, 0]], tan[idx[:, 1]], tan[idx[:, 2]]], 1))
    if tris_list:
        tris = np.ascontiguousarray(np.concatenate(tris_list), np.float32)
        tri_mat = np.ascontiguousarray(np.concatenate(tri_mat_list))
        tri_uv = np.ascontiguousarray(np.concatenate(tri_uv_list), np.float32)
        tri_tan = np.ascontiguousarray(np.concatenate(tri_tan_list),
                                       np.float32)
        n_tris = len(tris)
    else:
        tris = np.zeros((1, 9), np.float32)
        tri_mat = np.zeros(1, np.int32)
        tri_uv = np.zeros((1, 6), np.float32)
        tri_tan = np.zeros((1, 12), np.float32)
        n_tris = 0

    # base-color texture pool: the same resampled linear pool the JAX
    # samples (ops/textures.build_texture_arrays), level 0 only
    n_textures = tex_size = 0
    tex_data = np.zeros(1, np.float32)
    tex_wrap = np.zeros(2, np.int32)
    if resources.texture_images:
        from metal_pathtracer.ops.textures import build_texture_arrays
        wraps = resources.texture_wrap \
            if len(resources.texture_wrap) == len(resources.texture_images) \
            else None
        # The C++ side consumes one dense uniform pool: use the shared
        # native size when every texture already has one (then the oracle
        # sees EXACTLY the JAX path's level-0 texels); mixed-size scenes
        # resample to the 512^2 class (RMSE gates absorb that delta).
        shapes = {im.shape[:2] for im in resources.texture_images}
        if len(shapes) == 1 and len(set(shapes.pop())) == 1:
            side = resources.texture_images[0].shape[0]
            pool_size = side if (side & (side - 1)) == 0 else 512
        else:
            pool_size = 512
        ta = build_texture_arrays(resources.texture_images,
                                  resources.texture_srgb, wraps,
                                  size=pool_size)
        flat = np.asarray(ta.texels)
        offs = np.asarray(ta.level_offset[:, 0])
        base = np.stack([
            flat[int(o):int(o) + pool_size * pool_size].reshape(
                pool_size, pool_size, 4) for o in offs])
        tex_data = np.ascontiguousarray(base[..., :3], np.float32)
        tex_wrap = np.ascontiguousarray(np.asarray(ta.wrap_mode), np.int32)
        n_textures = tex_data.shape[0]
        tex_size = tex_data.shape[1]

    mats = pack_materials(resources)

    env_w = env_h = 0
    envf = np.zeros(1, np.float32)
    env_texels = env_marg_t = env_cond_t = env_pdf = envf
    env_marg_a = env_cond_a = np.zeros(1, np.int32)
    if environment is not None:
        env_w, env_h = environment.width, environment.height
        env_texels = np.ascontiguousarray(np.asarray(environment.texels),
                                          np.float32)
        env_marg_t = np.ascontiguousarray(
            np.asarray(environment.marginal_threshold), np.float32)
        env_marg_a = np.ascontiguousarray(
            np.asarray(environment.marginal_alias), np.int32)
        env_cond_t = np.ascontiguousarray(
            np.asarray(environment.conditional_threshold), np.float32)
        env_cond_a = np.ascontiguousarray(
            np.asarray(environment.conditional_alias), np.int32)
        env_pdf = np.ascontiguousarray(np.asarray(environment.pdf), np.float32)

    firefly = np.asarray([
        max(settings.fireflyClampFactor, 0.0),
        max(settings.fireflyClampFloor, 0.0),
        max(settings.throughputClamp, 0.0),
        max(settings.fireflyClampMaxContribution, 0.0),
        1.0 if settings.fireflyClampEnabled else 0.0], np.float32)

    out = np.zeros((height, width, 3), np.float32)
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int)
    ret = lib.render_oracle(
        ctypes.c_int(width), ctypes.c_int(height), ctypes.c_int(spp),
        ctypes.c_int(settings.maxDepth),
        ctypes.c_uint32(settings.fixedRngSeed),
        ctypes.c_int(1 if settings.enableRussianRoulette else 0),
        cam_flat.ctypes.data_as(fp),
        ctypes.c_int(int(settings.backgroundMode)),
        np.asarray(settings.backgroundColor, np.float32).ctypes.data_as(fp),
        ctypes.c_int(len(resources.spheres)),
        spheres.ctypes.data_as(fp), sph_mat.ctypes.data_as(ip),
        ctypes.c_int(len(resources.rects)),
        rects.ctypes.data_as(fp), rect_mat.ctypes.data_as(ip),
        rect_two.ctypes.data_as(ip),
        ctypes.c_int(n_tris), tris.ctypes.data_as(fp),
        tri_mat.ctypes.data_as(ip),
        tri_uv.ctypes.data_as(fp),
        tri_tan.ctypes.data_as(fp),
        ctypes.c_int(n_textures), ctypes.c_int(tex_size),
        tex_data.ctypes.data_as(fp), tex_wrap.ctypes.data_as(ip),
        ctypes.c_int(len(mats)), mats.ctypes.data_as(fp),
        ctypes.c_int(env_w), ctypes.c_int(env_h),
        env_texels.ctypes.data_as(fp),
        env_marg_t.ctypes.data_as(fp), env_marg_a.ctypes.data_as(ip),
        env_cond_t.ctypes.data_as(fp), env_cond_a.ctypes.data_as(ip),
        env_pdf.ctypes.data_as(fp),
        ctypes.c_float(settings.environmentRotation),
        ctypes.c_float(settings.environmentIntensity),
        firefly.ctypes.data_as(fp),
        ctypes.c_int(1 if settings.enableSpecularNee else 0),
        ctypes.c_int(1 if settings.enableMnee else 0),
        ctypes.c_int(1 if settings.enableMneeSecondary else 0),
        ctypes.c_int(int(settings.sssMode)),
        ctypes.c_int(int(settings.sssMaxSteps)),
        ctypes.c_int(1 if settings.debugAoIndirectOnly else 0),
        ctypes.c_int(n_threads),
        out.ctypes.data_as(fp))
    if ret != 0:
        raise RuntimeError(f"oracle render failed ({ret})")
    return out


def rmse(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.sqrt(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)))
