"""BVH traversal as one Pallas kernel through Triton: one lane per ray.

The XLA route (ops/traversal.py `_trace_xla`) advances a whole wavefront
one node per `lax.while_loop` step: every step is several gather kernels
plus a predicate over all lanes, and the loop runs as many steps as the
slowest lane needs. This kernel runs the same stackless exit-link walk
(scene/meshbuild.py) with the loop inside the kernel, so node fetches,
slab tests and leaf tests never leave registers between steps — the
reference's one-thread-per-ray software traversal
(reference: shaders/pathtrace.metal:1733-2384), minus its stack.

Each program owns a power-of-two block of lanes and loops until every
lane of the block has left the tree. Per step a lane gathers one 32-byte
node row and, at a leaf, up to MAX_LEAF 48-byte triangle rows that
pack_tables stored contiguously in leaf order (schema.TraversalTables), so a
leaf costs no indirection through the primitive index list.

Modes: closest hit, with (mesh, primitive) self-hit exclusion; and any
hit, where a lane ends on its first valid hit (shadow rays). The slab test
and Möller–Trumbore are the XLA route's own functions, so the routes
differ only by FMA contraction (utils/routecheck.py holds them to it).

`interpret=True` (a static field of the tables, set only by tests) runs
the kernel through the Pallas interpreter on the CPU.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from metal_pathtracer.ops.traversal import moller_trumbore, safe_inv_dir, \
    slab_test
from metal_pathtracer.scene.meshbuild import MAX_LEAF

#: int32 words per node row: bounds_min xyz, bounds_max xyz (float bits),
#: exit index, leaf word (prim_count | prim_offset << LEAF_SHIFT)
NODE_WORDS = 8
#: int32 words per leaf-order triangle row: v0 v1 v2 (float bits),
#: triangle id, mesh index, 1 pad
TRI_WORDS = 12
LEAF_SHIFT = 3
LEAF_MASK = (1 << LEAF_SHIFT) - 1


def pack_tables(nodes: dict, v0, v1, v2, mesh_index):
    """Host-side (numpy) node and leaf-order triangle rows for the kernel
    from a meshbuild.build_bvh node dict. Returns (node_rows, tri_rows),
    both int32 of shape (N, NODE_WORDS) and (P, TRI_WORDS)."""
    assert MAX_LEAF <= LEAF_MASK
    n = len(nodes["prim_count"])
    node_rows = np.zeros((n, NODE_WORDS), np.int32)
    f = lambda a: np.ascontiguousarray(a, np.float32).view(np.int32)
    node_rows[:, 0:3] = f(nodes["bounds_min"])
    node_rows[:, 3:6] = f(nodes["bounds_max"])
    node_rows[:, 6] = nodes["exit_index"]
    count = nodes["prim_count"].astype(np.int64)
    offset = np.where(count > 0, nodes["prim_offset"], 0).astype(np.int64)
    leaf_word = count | (offset << LEAF_SHIFT)
    assert leaf_word.max(initial=0) < 2 ** 31, "BVH too large for int32 rows"
    node_rows[:, 7] = leaf_word.astype(np.int32)

    ids = np.asarray(nodes["prim_indices"], np.int64)
    tri_rows = np.zeros((max(len(ids), 1), TRI_WORDS), np.int32)
    tri_rows[:len(ids), 0:3] = f(v0[ids])
    tri_rows[:len(ids), 3:6] = f(v1[ids])
    tri_rows[:len(ids), 6:9] = f(v2[ids])
    tri_rows[:len(ids), 9] = ids
    tri_rows[:len(ids), 10] = np.asarray(mesh_index)[ids]
    return node_rows, tri_rows


def _as_f32(x):
    return jax.lax.bitcast_convert_type(x, jnp.float32)


def _kernel(ox_ref, oy_ref, oz_ref, dx_ref, dy_ref, dz_ref, tmin_ref,
            tmax_ref, exm_ref, exp_ref, nodes_ref, tris_ref,
            t_ref, tri_ref, u_ref, v_ref, *, n_nodes: int, any_hit: bool):
    o = (ox_ref[...], oy_ref[...], oz_ref[...])
    d = (dx_ref[...], dy_ref[...], dz_ref[...])
    inv = tuple(safe_inv_dir(c) for c in d)
    t_min = tmin_ref[...]
    ex_mesh = exm_ref[...]
    ex_prim = exp_ref[...]

    def cond(state):
        node = state[0]
        return jnp.max((node < n_nodes).astype(jnp.int32)) > 0

    def body(state):
        node, best_t, best_tri, best_u, best_v = state
        active = node < n_nodes
        nd = jnp.minimum(node, n_nodes - 1)
        word = lambda k: plgpu.load(nodes_ref.at[nd, k], mask=active,
                                    other=0)
        bmin = tuple(_as_f32(word(k)) for k in range(3))
        bmax = tuple(_as_f32(word(k)) for k in range(3, 6))
        exit_node = word(6)
        leaf = word(7)
        box_hit = slab_test(o, inv, bmin, bmax, t_min, best_t)
        pcount = leaf & LEAF_MASK
        poff = leaf >> LEAF_SHIFT
        do_leaf = active & box_hit & (pcount > 0)
        for k in range(MAX_LEAF):
            slot_ok = do_leaf & (k < pcount)
            slot = poff + k
            tw = lambda w: plgpu.load(tris_ref.at[slot, w], mask=slot_ok,
                                      other=0)
            a = tuple(_as_f32(tw(w)) for w in range(0, 3))
            b = tuple(_as_f32(tw(w)) for w in range(3, 6))
            c = tuple(_as_f32(tw(w)) for w in range(6, 9))
            tri_id = tw(9)
            t, u, v, valid = moller_trumbore(o, d, a, b, c, t_min, best_t)
            excl = (tw(10) == ex_mesh) & (tri_id == ex_prim)
            better = slot_ok & valid & jnp.logical_not(excl) & (t < best_t)
            best_t = jnp.where(better, t, best_t)
            best_tri = jnp.where(better, tri_id, best_tri)
            best_u = jnp.where(better, u, best_u)
            best_v = jnp.where(better, v, best_v)

        descend = active & box_hit & (pcount == 0)
        node = jnp.where(active, jnp.where(descend, nd + 1, exit_node), node)
        if any_hit:
            node = jnp.where(best_tri >= 0, n_nodes, node)
        return node, best_t, best_tri, best_u, best_v

    lanes = ox_ref.shape[0]
    state = (jnp.zeros((lanes,), jnp.int32), tmax_ref[...],
             jnp.full((lanes,), -1, jnp.int32),
             jnp.zeros((lanes,), jnp.float32),
             jnp.zeros((lanes,), jnp.float32))
    _, best_t, best_tri, best_u, best_v = jax.lax.while_loop(cond, body,
                                                             state)
    t_ref[...] = best_t
    tri_ref[...] = best_tri
    u_ref[...] = best_u
    v_ref[...] = best_v


@functools.partial(jax.jit, static_argnames=("any_hit", "block", "interpret"))
def _call(lanes, node_rows, tri_rows, *, any_hit, block, interpret):
    n = lanes[0].shape[0]
    lane_spec = pl.BlockSpec((block,), lambda i: (i,))
    full = lambda a: pl.BlockSpec(a.shape, lambda i: (0, 0))
    kernel = functools.partial(_kernel, n_nodes=node_rows.shape[0],
                               any_hit=any_hit)
    return pl.pallas_call(
        kernel,
        grid=(n // block,),
        in_specs=[lane_spec] * len(lanes) + [full(node_rows),
                                             full(tri_rows)],
        out_specs=[lane_spec] * 4,
        out_shape=[jax.ShapeDtypeStruct((n,), jnp.float32),
                   jax.ShapeDtypeStruct((n,), jnp.int32),
                   jax.ShapeDtypeStruct((n,), jnp.float32),
                   jax.ShapeDtypeStruct((n,), jnp.float32)],
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=max(block // 32, 1), num_stages=1),
        interpret=interpret,
        name="bvh_any_hit" if any_hit else "bvh_closest_hit",
    )(*lanes, node_rows, tri_rows)


def trace(tables, origin, direction, t_min, t_max, exclude_mesh,
          exclude_prim, any_hit: bool = False):
    """(N,3) rays and (N,) per-lane windows/exclusions -> (t, tri, u, v).

    Lanes are padded to a whole number of blocks with empty windows
    (t_max = 0), which leave the tree at the root."""
    n = origin.shape[0]
    block = tables.block
    pad = (-n) % block

    def lane(x, fill):
        return jnp.pad(x, (0, pad), constant_values=fill) if pad else x

    lanes = ([lane(origin[:, a], 0.0) for a in range(3)]
             + [lane(direction[:, a], 1.0) for a in range(3)]
             + [lane(t_min, 0.0), lane(t_max, 0.0),
                lane(exclude_mesh, -1), lane(exclude_prim, -1)])
    out = _call(lanes, tables.node_rows, tables.tri_rows, any_hit=any_hit,
                block=block, interpret=tables.interpret)
    return tuple(x[:n] for x in out)
