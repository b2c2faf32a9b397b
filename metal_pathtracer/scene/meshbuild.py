"""Triangle array assembly and BVH construction.

Replaces the reference's acceleration-structure layer
(reference: src/renderer/SceneAccel.mm, src/renderer/BvhBuilder.mm:26-166,
external/tinybvh SAH BLAS): world-space meshes are merged into one flat
triangle soup with a single BVH over it, so every lane runs one uniform
traversal loop. Meshes placed many times can instead share one
object-space BVH (schema.InstanceGroup).

The BVH is built with binned SAH (the quality of tinybvh's BLAS rather
than the reference BvhBuilder's median split) and flattened depth-first
with **exit links** for stackless traversal (schema.BvhSoA). A native C++
builder (native/bvh_builder.cpp) is used when its shared library builds;
the numpy builder below is the reference implementation and fallback.
"""

from __future__ import annotations

import ctypes
import os
from typing import List, Optional, Tuple

import numpy as np

from metal_pathtracer.schema import BvhSoA, TraversalTables, TrianglesSoA

MAX_LEAF = 4
SAH_BINS = 16


# ---------------------------------------------------------------------------
# Triangle soup assembly
# ---------------------------------------------------------------------------

def build_triangle_arrays(meshes, traversal: str = "xla"):
    """Merge world-space meshes into SoA triangle arrays + BVH.

    traversal="kernel" (or "interpret", the same kernel run by the Pallas
    interpreter) also packs the traversal kernel's rows from the host-side
    soup. Returns (tris, bvh, tables); tables is None for "xla"."""
    import jax.numpy as jnp

    v0s, v1s, v2s = [], [], []
    n0s, n1s, n2s = [], [], []
    uv0s, uv1s, uv2s = [], [], []
    uvb0s, uvb1s, uvb2s = [], [], []
    t0s, t1s, t2s = [], [], []
    mats, mesh_ids = [], []

    for mesh_index, mesh in enumerate(meshes):
        idx = mesh.indices.astype(np.int64)
        v = mesh.vertices.astype(np.float32)
        n = mesh.normals.astype(np.float32)
        uv = mesh.uv0.astype(np.float32)
        uvb = mesh.uv1.astype(np.float32)
        tan = mesh.tangents.astype(np.float32)
        i0, i1, i2 = idx[:, 0], idx[:, 1], idx[:, 2]
        v0s.append(v[i0]); v1s.append(v[i1]); v2s.append(v[i2])
        n0s.append(n[i0]); n1s.append(n[i1]); n2s.append(n[i2])
        uv0s.append(uv[i0]); uv1s.append(uv[i1]); uv2s.append(uv[i2])
        uvb0s.append(uvb[i0]); uvb1s.append(uvb[i1]); uvb2s.append(uvb[i2])
        t0s.append(tan[i0]); t1s.append(tan[i1]); t2s.append(tan[i2])
        f = len(i0)
        mats.append(np.full(f, mesh.material, np.int32))
        mesh_ids.append(np.full(f, mesh_index, np.int32))

    cat = lambda xs: np.concatenate(xs, 0)
    v0, v1, v2 = cat(v0s), cat(v1s), cat(v2s)

    nodes = build_bvh(v0, v1, v2)

    j = lambda a: jnp.asarray(a)
    mat_arr = cat(mats)
    mesh_arr = cat(mesh_ids)
    n0a, n1a, n2a = cat(n0s), cat(n1s), cat(n2s)
    T = len(v0)
    shade = np.zeros((T, 24), np.float32)
    shade[:, 0:3] = v0
    shade[:, 3:6] = v1
    shade[:, 6:9] = v2
    shade[:, 9:12] = n0a
    shade[:, 12:15] = n1a
    shade[:, 15:18] = n2a
    shade[:, 18] = mat_arr
    shade[:, 19] = mesh_arr
    tris = TrianglesSoA(
        v0=j(v0), v1=j(v1), v2=j(v2),
        material=j(mat_arr), mesh_index=j(mesh_arr),
        n0=j(n0a), n1=j(n1a), n2=j(n2a),
        uv0=j(cat(uv0s)), uv1=j(cat(uv1s)), uv2=j(cat(uv2s)),
        uvb0=j(cat(uvb0s)), uvb1=j(cat(uvb1s)), uvb2=j(cat(uvb2s)),
        t0=j(cat(t0s)), t1=j(cat(t1s)), t2=j(cat(t2s)),
        shade_packed=j(shade),
    )
    bvh = BvhSoA(
        bounds_min=j(nodes["bounds_min"]),
        bounds_max=j(nodes["bounds_max"]),
        prim_offset=j(nodes["prim_offset"]),
        prim_count=j(nodes["prim_count"]),
        exit_index=j(nodes["exit_index"]),
        prim_indices=j(nodes["prim_indices"]),
    )
    tables = None
    if traversal != "xla":
        from metal_pathtracer.ops.pallas.traverse import pack_tables
        node_rows, tri_rows = pack_tables(nodes, v0, v1, v2, mesh_arr)
        tables = TraversalTables(node_rows=j(node_rows),
                                 tri_rows=j(tri_rows),
                                 interpret=traversal == "interpret")
    return tris, bvh, tables


# ---------------------------------------------------------------------------
# Binned SAH builder (numpy) with DFS flattening + exit links
# ---------------------------------------------------------------------------

def _native_lib():
    from metal_pathtracer.utils.nativebuild import ensure_built
    path = ensure_built("libbvh_builder.so")
    if path is not None:
        try:
            return ctypes.CDLL(path)
        except OSError:
            return None
    return None


def build_bvh(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray) -> dict:
    """Binned-SAH BVH, flattened depth-first with exit links.

    Node layout (schema.BvhSoA): internal nodes are followed immediately by
    their near subtree; `exit_index` says where traversal continues on an
    AABB miss (or after a leaf) — the stackless analogue of the reference's
    128-entry traversal stack (pathtrace.metal:36, 1733-2384).
    """
    lib = _native_lib()
    if lib is not None:
        try:
            return _build_bvh_native(lib, v0, v1, v2)
        except Exception:
            pass
    return _build_bvh_numpy(v0, v1, v2)


def _build_bvh_native(lib, v0, v1, v2) -> dict:
    n = v0.shape[0]
    verts = np.concatenate(
        [v0.astype(np.float32), v1.astype(np.float32), v2.astype(np.float32)],
        axis=1)  # (n, 9)
    verts = np.ascontiguousarray(verts)
    max_nodes = max(2 * n, 1)
    bounds_min = np.zeros((max_nodes, 3), np.float32)
    bounds_max = np.zeros((max_nodes, 3), np.float32)
    prim_offset = np.zeros(max_nodes, np.int32)
    prim_count = np.zeros(max_nodes, np.int32)
    exit_index = np.zeros(max_nodes, np.int32)
    prim_indices = np.zeros(n, np.int32)

    lib.build_bvh_sah.restype = ctypes.c_int
    n_nodes = lib.build_bvh_sah(
        ctypes.c_int(n),
        verts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        bounds_min.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        bounds_max.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        prim_offset.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        prim_count.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        exit_index.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        prim_indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        ctypes.c_int(MAX_LEAF),
        ctypes.c_int(SAH_BINS),
    )
    if n_nodes <= 0:
        raise RuntimeError("native BVH build failed")
    return {
        "bounds_min": bounds_min[:n_nodes],
        "bounds_max": bounds_max[:n_nodes],
        "prim_offset": prim_offset[:n_nodes],
        "prim_count": prim_count[:n_nodes],
        "exit_index": exit_index[:n_nodes],
        "prim_indices": prim_indices,
    }


def _build_bvh_numpy(v0, v1, v2) -> dict:
    n = v0.shape[0]
    tri_min = np.minimum(np.minimum(v0, v1), v2)
    tri_max = np.maximum(np.maximum(v0, v1), v2)
    centroid = (tri_min + tri_max) * 0.5

    order = np.arange(n, dtype=np.int32)

    bounds_min: List[np.ndarray] = []
    bounds_max: List[np.ndarray] = []
    prim_offset: List[int] = []
    prim_count: List[int] = []
    children: List[Tuple[int, int]] = []  # (left, right) or (-1,-1) for leaf

    prim_out: List[np.ndarray] = []
    out_cursor = 0

    def surface(mn, mx):
        d = np.maximum(mx - mn, 0.0)
        return 2.0 * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0])

    def build(ids: np.ndarray) -> int:
        nonlocal out_cursor
        node = len(bounds_min)
        bmin = tri_min[ids].min(0)
        bmax = tri_max[ids].max(0)
        bounds_min.append(bmin)
        bounds_max.append(bmax)
        prim_offset.append(0)
        prim_count.append(0)
        children.append((-1, -1))

        def make_leaf():
            prim_offset[node] = out_cursor_local()
            prim_count[node] = len(ids)
            prim_out.append(ids)

        def out_cursor_local():
            return sum(len(a) for a in prim_out)

        if len(ids) <= MAX_LEAF:
            make_leaf()
            return node

        c = centroid[ids]
        cmin, cmax = c.min(0), c.max(0)
        extent = cmax - cmin
        axis = int(np.argmax(extent))
        if extent[axis] <= 1e-12:
            make_leaf()
            return node

        # Binned SAH over the widest centroid axis
        nb = SAH_BINS
        scale = nb / extent[axis]
        bin_ids = np.minimum(((c[:, axis] - cmin[axis]) * scale).astype(np.int32),
                             nb - 1)
        bin_counts = np.bincount(bin_ids, minlength=nb)
        bin_min = np.full((nb, 3), np.inf)
        bin_max = np.full((nb, 3), -np.inf)
        for b in range(nb):
            mask = bin_ids == b
            if bin_counts[b]:
                bin_min[b] = tri_min[ids[mask]].min(0)
                bin_max[b] = tri_max[ids[mask]].max(0)

        # prefix/suffix areas
        left_counts = np.cumsum(bin_counts)[:-1]
        right_counts = len(ids) - left_counts
        lmin = np.minimum.accumulate(bin_min, 0)
        lmax = np.maximum.accumulate(bin_max, 0)
        rmin = np.minimum.accumulate(bin_min[::-1], 0)[::-1]
        rmax = np.maximum.accumulate(bin_max[::-1], 0)[::-1]
        cost = np.full(nb - 1, np.inf)
        for s in range(nb - 1):
            if left_counts[s] == 0 or right_counts[s] == 0:
                continue
            cost[s] = (surface(lmin[s], lmax[s]) * left_counts[s]
                       + surface(rmin[s + 1], rmax[s + 1]) * right_counts[s])
        best = int(np.argmin(cost))
        parent_area = surface(bmin, bmax)
        leaf_cost = len(ids) * parent_area
        if not np.isfinite(cost[best]) or cost[best] >= leaf_cost \
                and len(ids) <= 2 * MAX_LEAF:
            # SAH says don't split and the node is small: make a leaf
            make_leaf()
            return node

        go_left = bin_ids <= best
        if not np.isfinite(cost[best]) or go_left.all() or not go_left.any():
            # Degenerate: median split fallback (reference BvhBuilder.mm:26-166)
            med = np.argsort(c[:, axis], kind="stable")
            half = len(ids) // 2
            left_ids = ids[med[:half]]
            right_ids = ids[med[half:]]
        else:
            left_ids = ids[go_left]
            right_ids = ids[~go_left]

        left = build(left_ids)
        right = build(right_ids)
        children[node] = (left, right)
        return node

    import sys
    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10000 + 2 * int(np.log2(max(n, 2))) * 64))
    try:
        build(order)
    finally:
        sys.setrecursionlimit(old_limit)

    prim_indices = np.concatenate(prim_out).astype(np.int32) if prim_out \
        else np.zeros(0, np.int32)

    return _flatten_with_exit_links(
        np.asarray(bounds_min, np.float32), np.asarray(bounds_max, np.float32),
        np.asarray(prim_offset, np.int32), np.asarray(prim_count, np.int32),
        children, prim_indices)


def _flatten_with_exit_links(bmin, bmax, poff, pcnt, children, prim_indices) -> dict:
    """Reorder nodes depth-first (left child adjacent) and add exit links."""
    n_nodes = len(bmin)
    new_index = np.full(n_nodes, -1, np.int32)
    order: List[int] = []

    # Iterative DFS, left first
    stack = [0]
    while stack:
        node = stack.pop()
        new_index[node] = len(order)
        order.append(node)
        left, right = children[node]
        if left >= 0:
            stack.append(right)
            stack.append(left)

    exit_index = np.zeros(n_nodes, np.int32)

    def assign_exit(node: int, exit_to: int):
        # Iterative version of: left exits into right; right exits to parent's exit
        work = [(node, exit_to)]
        while work:
            nd, ex = work.pop()
            exit_index[new_index[nd]] = ex
            left, right = children[nd]
            if left >= 0:
                work.append((left, new_index[right]))
                work.append((right, ex))

    assign_exit(0, len(order))

    inv = np.asarray(order, np.int64)
    return {
        "bounds_min": bmin[inv],
        "bounds_max": bmax[inv],
        "prim_offset": poff[inv],
        "prim_count": pcnt[inv],
        "exit_index": exit_index,
        "prim_indices": prim_indices,
    }
