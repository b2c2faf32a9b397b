"""`mesh` record handling for the .scene DSL.

Dispatches OBJ / PLY / glTF by extension and composes TRS transforms
(reference: src/renderer/SceneManager.mm parseMesh:2362-2634).
"""

from __future__ import annotations

import math
import os

import numpy as np

from metal_pathtracer.scene.dsl import (
    SceneParseError,
    parse_float,
    parse_float3,
    parse_uint,
)


def _rotation_matrix(rx: float, ry: float, rz: float) -> np.ndarray:
    """Euler XYZ rotation, degrees (reference: SceneManager.mm TRS compose)."""
    rx, ry, rz = (math.radians(v) for v in (rx, ry, rz))
    cx, sx = math.cos(rx), math.sin(rx)
    cy, sy = math.cos(ry), math.sin(ry)
    cz, sz = math.cos(rz), math.sin(rz)
    mx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    my = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    mz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return mz @ my @ mx


def mesh_loader(tokens, settings, resources, allow_camera_import: bool,
                scene_directory: str) -> None:
    """Load a `mesh path=... [translate= rotate= scale= material=]` record."""
    path = tokens.get("path") or tokens.get("file")
    if not path:
        raise SceneParseError("mesh requires a path (or file) token")
    if not os.path.isabs(path):
        path = os.path.join(scene_directory or ".", path)
    path = os.path.normpath(path)
    if not os.path.exists(path):
        raise SceneParseError(f"mesh file not found: {path}")

    translate = (0.0, 0.0, 0.0)
    for key in ("translate", "position"):
        if key in tokens:
            translate = parse_float3(tokens[key])
            break
    rotate = parse_float3(tokens["rotate"]) if "rotate" in tokens else (0.0, 0.0, 0.0)
    if "scale" in tokens:
        value = tokens["scale"]
        if "," in value:
            scale = parse_float3(value)
        else:
            s = parse_float(value)
            scale = (s, s, s)
    else:
        scale = (1.0, 1.0, 1.0)

    material = 0
    if "material" in tokens:
        value = tokens["material"]
        if value.isdigit():
            material = parse_uint(value)
            if material >= resources.material_count():
                raise SceneParseError(
                    "mesh references material index that has not been defined yet")
        elif value in resources.material_names:
            material = resources.material_names[value]
        else:
            raise SceneParseError(f"mesh references unknown material name: {value}")

    # TRS compose: T * R * S (column-vector convention)
    tf = np.eye(4)
    tf[:3, :3] = _rotation_matrix(*rotate) @ np.diag(scale)
    tf[:3, 3] = translate

    ext = os.path.splitext(path)[1].lower()
    name = tokens.get("name", os.path.basename(path))
    # instanced=1: share ONE object-space BLAS across every placement of
    # this file instead of baking world-space copies (true instancing,
    # reference: SceneAccel.mm SoftwareInstanceInfo)
    instanced = tokens.get("instanced", "0") == "1"
    if instanced and ext in (".obj", ".ply"):
        cache = getattr(resources, "_instance_mesh_cache", None)
        if cache is None:
            cache = {}
            resources._instance_mesh_cache = cache
        if path not in cache:
            if ext == ".obj":
                from metal_pathtracer.scene.obj import load_obj
                cache[path] = load_obj(path, name=name, material=material,
                                       transform=np.eye(4))
            else:
                from metal_pathtracer.scene.ply import load_ply
                cache[path] = load_ply(path, name=name, material=material,
                                       transform=np.eye(4))
        resources.add_mesh_instance(cache[path], tf, material)
        return
    if ext == ".obj":
        from metal_pathtracer.scene.obj import load_obj
        mesh = load_obj(path, name=name, material=material, transform=tf)
        resources.add_mesh(mesh)
    elif ext == ".ply":
        from metal_pathtracer.scene.ply import load_ply
        mesh = load_ply(path, name=name, material=material, transform=tf)
        resources.add_mesh(mesh)
    elif ext in (".gltf", ".glb"):
        from metal_pathtracer.scene.gltf import load_gltf_into
        load_gltf_into(path, settings, resources, tf,
                       allow_camera_import=allow_camera_import, tokens=tokens)
    else:
        raise SceneParseError(f"unsupported mesh format: {ext}")
