"""Tangent basis generation.

Primary path: vendored MikkTSpace (native/mikktspace/, the glTF-standard
spec implementation) via a ctypes wrapper, matching the reference's
TangentGen adapter (reference: src/assets/TangentGen.mm:8-110). Fallback:
the reference's UV-derivative accumulation (`:24-110`) — per-face tangents
from UV deltas accumulated per vertex, Gram-Schmidt orthogonalized against
the normal, handedness from the bitangent triple product — used when the
native library is unavailable or MikkTSpace rejects the mesh.
"""

from __future__ import annotations

import ctypes

import numpy as np

_mikkt_lib = None
_mikkt_tried = False


def _load_mikkt():
    global _mikkt_lib, _mikkt_tried
    if _mikkt_tried:
        return _mikkt_lib
    _mikkt_tried = True
    try:
        from metal_pathtracer.utils.nativebuild import ensure_built
        path = ensure_built("libtangentgen.so")
        if path is None:
            return None
        lib = ctypes.CDLL(path)
        lib.mikkt_generate_tangents.restype = ctypes.c_int
        fp = ctypes.POINTER(ctypes.c_float)
        ip = ctypes.POINTER(ctypes.c_int)
        lib.mikkt_generate_tangents.argtypes = [
            ctypes.c_int, fp, fp, fp, ip, fp]
        _mikkt_lib = lib
    except Exception:
        _mikkt_lib = None
    return _mikkt_lib


def generate_tangents_mikktspace(positions: np.ndarray, normals: np.ndarray,
                                 uvs: np.ndarray,
                                 faces: np.ndarray) -> np.ndarray | None:
    """-> (V,4) MikkTSpace tangents, or None if unavailable/rejected."""
    lib = _load_mikkt()
    if lib is None:
        return None
    pos = np.ascontiguousarray(positions, np.float32)
    nrm = np.ascontiguousarray(normals, np.float32)
    uv = np.ascontiguousarray(uvs, np.float32)
    idx = np.ascontiguousarray(faces, np.int32)
    out = np.zeros((len(pos), 4), np.float32)
    out[:, 0] = 1.0  # rejected/unreferenced vertices keep a valid basis
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int)
    ok = lib.mikkt_generate_tangents(
        ctypes.c_int(len(idx)), pos.ctypes.data_as(fp),
        nrm.ctypes.data_as(fp), uv.ctypes.data_as(fp),
        idx.ctypes.data_as(ip), out.ctypes.data_as(fp))
    return out if ok else None


def generate_tangents(positions: np.ndarray, normals: np.ndarray,
                      uvs: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """-> (V,4) float32 tangent xyz + handedness w (MikkTSpace when the
    native library is present, UV-derivative fallback otherwise)."""
    mikkt = generate_tangents_mikktspace(positions, normals, uvs, faces)
    if mikkt is not None:
        return mikkt
    return generate_tangents_fallback(positions, normals, uvs, faces)


def generate_tangents_fallback(positions: np.ndarray, normals: np.ndarray,
                               uvs: np.ndarray,
                               faces: np.ndarray) -> np.ndarray:
    """-> (V,4) float32 tangent xyz + handedness w."""
    v = len(positions)
    tan = np.zeros((v, 3), np.float64)
    bitan = np.zeros((v, 3), np.float64)

    i0, i1, i2 = faces[:, 0], faces[:, 1], faces[:, 2]
    e1 = positions[i1] - positions[i0]
    e2 = positions[i2] - positions[i0]
    duv1 = uvs[i1] - uvs[i0]
    duv2 = uvs[i2] - uvs[i0]
    det = duv1[:, 0] * duv2[:, 1] - duv2[:, 0] * duv1[:, 1]
    r = np.where(np.abs(det) > 1e-12, 1.0 / np.where(det == 0, 1, det), 0.0)
    t = (e1 * duv2[:, 1:2] - e2 * duv1[:, 1:2]) * r[:, None]
    b = (e2 * duv1[:, 0:1] - e1 * duv2[:, 0:1]) * r[:, None]

    for c in (i0, i1, i2):
        np.add.at(tan, c, t)
        np.add.at(bitan, c, b)

    n = normals.astype(np.float64)
    # Gram-Schmidt: t' = normalize(t - n * (n . t))
    t_ortho = tan - n * (n * tan).sum(-1, keepdims=True)
    ln = np.linalg.norm(t_ortho, axis=-1, keepdims=True)
    fallback = np.zeros_like(t_ortho)
    fallback[:, 0] = 1.0
    t_ortho = np.where(ln > 1e-9, t_ortho / np.maximum(ln, 1e-20), fallback)

    handed = np.where((np.cross(n, t_ortho) * bitan).sum(-1) < 0.0, -1.0, 1.0)
    out = np.zeros((v, 4), np.float32)
    out[:, :3] = t_ortho
    out[:, 3] = handed
    return out
