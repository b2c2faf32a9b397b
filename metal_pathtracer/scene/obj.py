"""Wavefront OBJ loader.

Python replacement for the reference's tinyobjloader path
(reference: src/renderer/SceneManager.mm LoadObjMesh:96-211): triangulates
polygon faces as fans, deduplicates (position, normal, uv) index triples,
and fills missing normals with flat face normals per triangle
(ApplyFallbackNormals, SceneManager.mm:60-94).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from metal_pathtracer.scene.resources import Mesh


def _parse_index(token: str, count: int) -> Tuple[int, int, int]:
    """`v`, `v/vt`, `v//vn`, `v/vt/vn` with negative (relative) indices."""
    parts = token.split("/")
    def conv(s, n):
        if not s:
            return -1
        i = int(s)
        return i - 1 if i > 0 else n + i
    v = conv(parts[0], count[0])
    vt = conv(parts[1], count[1]) if len(parts) > 1 else -1
    vn = conv(parts[2], count[2]) if len(parts) > 2 else -1
    return v, vt, vn


def load_obj_raw(path: str):
    """Parse an OBJ into deduplicated vertex arrays + triangle indices."""
    positions: List[Tuple[float, float, float]] = []
    normals: List[Tuple[float, float, float]] = []
    uvs: List[Tuple[float, float]] = []
    faces: List[List[str]] = []

    with open(path, "r", errors="replace") as f:
        for line in f:
            if line.startswith("v "):
                p = line.split()
                positions.append((float(p[1]), float(p[2]), float(p[3])))
            elif line.startswith("vn "):
                p = line.split()
                normals.append((float(p[1]), float(p[2]), float(p[3])))
            elif line.startswith("vt "):
                p = line.split()
                uvs.append((float(p[1]), float(p[2])))
            elif line.startswith("f "):
                toks = line.split()[1:]
                if len(toks) >= 3:
                    faces.append(toks)

    if not positions:
        raise ValueError(f"OBJ file contains no vertex positions: {path}")
    if not faces:
        raise ValueError(f"OBJ file contains no triangle data: {path}")

    counts = (len(positions), len(uvs), len(normals))
    lookup: Dict[Tuple[int, int, int], int] = {}
    out_pos: List = []
    out_nrm: List = []
    out_uv: List = []
    indices: List[Tuple[int, int, int]] = []

    def vertex(tok: str) -> int:
        v, vt, vn = _parse_index(tok, counts)
        key = (v, vn, vt)
        idx = lookup.get(key)
        if idx is None:
            idx = len(out_pos)
            lookup[key] = idx
            out_pos.append(positions[v])
            out_nrm.append(normals[vn] if 0 <= vn < len(normals) else (0.0, 0.0, 0.0))
            out_uv.append(uvs[vt] if 0 <= vt < len(uvs) else (0.0, 0.0))
        return idx

    for face in faces:
        ids = [vertex(t) for t in face]
        for k in range(1, len(ids) - 1):  # fan triangulation
            indices.append((ids[0], ids[k], ids[k + 1]))

    pos = np.asarray(out_pos, np.float32)
    nrm = np.asarray(out_nrm, np.float32)
    uv = np.asarray(out_uv, np.float32)
    idx = np.asarray(indices, np.int32)

    # Flat-normal fallback for triangles whose corners all lack normals
    have = np.linalg.norm(nrm, axis=-1) > 0.0
    tri_have = have[idx].any(-1)
    missing = np.nonzero(~tri_have)[0]
    if missing.size:
        i = idx[missing]
        e1 = pos[i[:, 1]] - pos[i[:, 0]]
        e2 = pos[i[:, 2]] - pos[i[:, 0]]
        fn = np.cross(e1, e2)
        ln = np.linalg.norm(fn, axis=-1, keepdims=True)
        ok = ln[:, 0] > 0.0
        fn = np.where(ln > 0.0, fn / np.maximum(ln, 1e-30), fn)
        for row, normal, good in zip(i, fn, ok):
            if good:
                nrm[row] = normal
    return pos, nrm, uv, idx


def load_obj(path: str, name: str = "", material: int = 0,
             transform: np.ndarray = None) -> Mesh:
    pos, nrm, uv, idx = load_obj_raw(path)
    if transform is not None:
        tf = np.asarray(transform, np.float64)
        pos = (pos @ tf[:3, :3].T + tf[:3, 3]).astype(np.float32)
        # Normals transform by the inverse-transpose
        nit = np.linalg.inv(tf[:3, :3]).T
        nrm = (nrm @ nit.T).astype(np.float32)
        ln = np.linalg.norm(nrm, axis=-1, keepdims=True)
        nrm = np.where(ln > 0, nrm / np.maximum(ln, 1e-30), nrm).astype(np.float32)

    zeros4 = np.zeros((len(pos), 4), np.float32)
    return Mesh(name=name or path, vertices=pos, normals=nrm, uv0=uv,
                uv1=np.zeros_like(uv), tangents=zeros4,
                indices=idx, material=material)
