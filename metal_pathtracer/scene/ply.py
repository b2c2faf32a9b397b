"""PLY loader (ascii + binary little/big endian).

Python replacement for the reference's tinyply path
(reference: src/renderer/SceneManager.mm LoadPlyMesh:223-519): reads
vertex x/y/z (+ optional nx/ny/nz, s/t or u/v), face vertex_indices lists,
fan-triangulates, and falls back to flat normals.
"""

from __future__ import annotations

import struct
from typing import List

import numpy as np

from metal_pathtracer.scene.resources import Mesh

_TYPES = {
    "char": ("b", 1), "int8": ("b", 1),
    "uchar": ("B", 1), "uint8": ("B", 1),
    "short": ("h", 2), "int16": ("h", 2),
    "ushort": ("H", 2), "uint16": ("H", 2),
    "int": ("i", 4), "int32": ("i", 4),
    "uint": ("I", 4), "uint32": ("I", 4),
    "float": ("f", 4), "float32": ("f", 4),
    "double": ("d", 8), "float64": ("d", 8),
}


def load_ply_raw(path: str):
    with open(path, "rb") as f:
        data = f.read()

    # --- header
    if not data.startswith(b"ply"):
        raise ValueError(f"not a PLY file: {path}")
    header_end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:header_end].decode("ascii", errors="replace").splitlines()
    body = data[header_end:]

    fmt = "ascii"
    elements = []  # (name, count, [(prop_name, type, list_count_type|None)])
    for line in header:
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property":
            if parts[1] == "list":
                elements[-1][2].append((parts[4], parts[3], parts[2]))
            else:
                elements[-1][2].append((parts[2], parts[1], None))

    verts = {}
    faces: List[List[int]] = []

    if fmt == "ascii":
        tokens = body.decode("ascii", errors="replace").split()
        pos = 0
        for name, count, props in elements:
            if name == "vertex":
                cols = {p[0]: [] for p in props}
                for _ in range(count):
                    for pname, _ptype, _l in props:
                        cols[pname].append(float(tokens[pos])); pos += 1
                verts = {k: np.asarray(v, np.float32) for k, v in cols.items()}
            elif name == "face":
                for _ in range(count):
                    for pname, _ptype, ltype in props:
                        if ltype is not None:
                            n = int(tokens[pos]); pos += 1
                            ids = [int(tokens[pos + k]) for k in range(n)]
                            pos += n
                            if pname in ("vertex_indices", "vertex_index"):
                                faces.append(ids)
                        else:
                            pos += 1
            else:
                for _ in range(count):
                    for pname, _ptype, ltype in props:
                        if ltype is not None:
                            n = int(tokens[pos]); pos += 1 + n
                        else:
                            pos += 1
    else:
        endian = "<" if "little" in fmt else ">"
        off = 0
        for name, count, props in elements:
            if name == "vertex" and all(p[2] is None for p in props):
                # fast path: fixed-stride vertex block
                fmt_str = endian + "".join(_TYPES[p[1]][0] for p in props)
                stride = struct.calcsize(fmt_str)
                arr = np.frombuffer(body, dtype=np.dtype(
                    [(p[0], endian + _TYPES[p[1]][0]) for p in props]),
                    count=count, offset=off)
                off += stride * count
                verts = {p[0]: arr[p[0]].astype(np.float32) for p in props}
            else:
                for _ in range(count):
                    face_ids = None
                    for pname, ptype, ltype in props:
                        if ltype is not None:
                            lc, lsz = _TYPES[ltype]
                            (n,) = struct.unpack_from(endian + lc, body, off)
                            off += lsz
                            ic, isz = _TYPES[ptype]
                            ids = struct.unpack_from(endian + ic * n, body, off)
                            off += isz * n
                            if pname in ("vertex_indices", "vertex_index"):
                                face_ids = list(ids)
                        else:
                            _c, sz = _TYPES[ptype]
                            off += sz
                    if name == "face" and face_ids is not None:
                        faces.append(face_ids)

    if "x" not in verts:
        raise ValueError(f"PLY file has no vertex positions: {path}")
    pos = np.stack([verts["x"], verts["y"], verts["z"]], -1)
    if "nx" in verts:
        nrm = np.stack([verts["nx"], verts["ny"], verts["nz"]], -1)
    else:
        nrm = np.zeros_like(pos)
    if "s" in verts:
        uv = np.stack([verts["s"], verts["t"]], -1)
    elif "u" in verts:
        uv = np.stack([verts["u"], verts["v"]], -1)
    else:
        uv = np.zeros((len(pos), 2), np.float32)

    tri: List = []
    for ids in faces:
        for k in range(1, len(ids) - 1):
            tri.append((ids[0], ids[k], ids[k + 1]))
    idx = np.asarray(tri, np.int32)
    if idx.size == 0:
        raise ValueError(f"PLY file contains no faces: {path}")

    # Flat normals where missing
    if np.linalg.norm(nrm, axis=-1).max() <= 0.0:
        nrm = np.zeros_like(pos)
        e1 = pos[idx[:, 1]] - pos[idx[:, 0]]
        e2 = pos[idx[:, 2]] - pos[idx[:, 0]]
        fn = np.cross(e1, e2)
        ln = np.linalg.norm(fn, axis=-1, keepdims=True)
        fn = np.where(ln > 0, fn / np.maximum(ln, 1e-30), fn)
        for c in range(3):
            np.add.at(nrm, idx[:, c], fn)
        ln = np.linalg.norm(nrm, axis=-1, keepdims=True)
        nrm = np.where(ln > 0, nrm / np.maximum(ln, 1e-30), nrm)
    return pos.astype(np.float32), nrm.astype(np.float32), uv.astype(np.float32), idx


def load_ply(path: str, name: str = "", material: int = 0,
             transform: np.ndarray = None) -> Mesh:
    pos, nrm, uv, idx = load_ply_raw(path)
    if transform is not None:
        tf = np.asarray(transform, np.float64)
        pos = (pos @ tf[:3, :3].T + tf[:3, 3]).astype(np.float32)
        nit = np.linalg.inv(tf[:3, :3]).T
        nrm = (nrm @ nit.T).astype(np.float32)
        ln = np.linalg.norm(nrm, axis=-1, keepdims=True)
        nrm = np.where(ln > 0, nrm / np.maximum(ln, 1e-30), nrm).astype(np.float32)
    zeros4 = np.zeros((len(pos), 4), np.float32)
    return Mesh(name=name or path, vertices=pos, normals=nrm, uv0=uv,
                uv1=np.zeros_like(uv), tangents=zeros4,
                indices=idx, material=material)
