"""Procedural benchmark geometry.

The BASELINE benchmark names the Stanford Dragon (~870k triangles); this
zero-egress environment has no asset downloads, so `dragon_class_mesh`
generates a displaced icosphere with a comparable triangle count, surface
detail, and BVH depth — the honest stand-in used by bench.py (labelled
procedural in the metric name).
"""

from __future__ import annotations

import numpy as np


def icosphere(subdivisions: int):
    """Subdivided icosahedron: 20 * 4^n triangles."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
    ], np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ], np.int64)

    for _ in range(subdivisions):
        edge_mid = {}
        new_faces = []
        verts_list = [v for v in verts]

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in edge_mid:
                m = verts_list[a] + verts_list[b]
                m = m / np.linalg.norm(m)
                edge_mid[key] = len(verts_list)
                verts_list.append(m)
            return edge_mid[key]

        for f in faces:
            a, b, c = f
            ab = midpoint(a, b)
            bc = midpoint(b, c)
            ca = midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.asarray(verts_list)
        faces = np.asarray(new_faces, np.int64)
    return verts, faces


def _fbm(p: np.ndarray, octaves: int = 5, seed: int = 7) -> np.ndarray:
    """Cheap value-noise fBm over unit-sphere points (vectorized)."""
    rng = np.random.default_rng(seed)
    out = np.zeros(len(p))
    amp = 1.0
    freq = 1.5
    for _ in range(octaves):
        phase = rng.uniform(0, 2 * np.pi, 3)
        dirs = rng.normal(size=(3, 3))
        for k in range(3):
            out += amp * np.sin(freq * (p @ dirs[k]) + phase[k])
        amp *= 0.5
        freq *= 2.03
    return out / 4.0


def dragon_class_mesh(subdivisions: int = 6, seed: int = 7):
    """Displaced icosphere: 20*4^6 = 81,920 tris at n=6; 1.3M at n=8.

    Returns (vertices (V,3) f32, normals (V,3) f32, faces (F,3) i32).
    """
    verts, faces = icosphere(subdivisions)
    disp = 1.0 + 0.25 * _fbm(verts, seed=seed)
    pos = (verts * disp[:, None]).astype(np.float32)

    # area-weighted vertex normals
    normals = np.zeros_like(pos)
    e1 = pos[faces[:, 1]] - pos[faces[:, 0]]
    e2 = pos[faces[:, 2]] - pos[faces[:, 0]]
    fn = np.cross(e1, e2)
    for c in range(3):
        np.add.at(normals, faces[:, c], fn)
    ln = np.linalg.norm(normals, axis=1, keepdims=True)
    normals = (normals / np.maximum(ln, 1e-20)).astype(np.float32)
    return pos, normals, faces.astype(np.int32)


def dragon_class_scene_mesh(subdivisions: int = 6, material: int = 0):
    from metal_pathtracer.scene.resources import Mesh

    pos, normals, faces = dragon_class_mesh(subdivisions)
    uv = np.zeros((len(pos), 2), np.float32)
    return Mesh(name=f"dragon-class-{subdivisions}", vertices=pos,
                normals=normals, uv0=uv, uv1=uv.copy(),
                tangents=np.zeros((len(pos), 4), np.float32),
                indices=faces, material=material)
