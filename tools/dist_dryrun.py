"""Multi-host (DCN) dryrun worker: validates parallel/mesh.py's claim that
`jax.distributed.initialize()` + the same shard_map path works across
process groups (SURVEY.md §5.8; VERDICT r04 missing #5).

Launched as N cooperating processes (tests/test_distributed.py spawns 2)
each owning a few virtual CPU devices:

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=2 \
    python tools/dist_dryrun.py --coordinator=127.0.0.1:PORT \
        --num-processes=2 --process-id=K

Each process renders the toy frame over the GLOBAL mesh, then checks its
addressable shards bit-exactly against a locally computed single-device
render (per-pixel RNG is absolute, so shard layout cannot change pixels).
Prints DIST_DRYRUN_OK on success; any mismatch or collective failure
exits non-zero.
"""

from __future__ import annotations

import argparse
import os
import sys


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    args = ap.parse_args()

    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    import numpy as np

    # wins over any platform an installed plugin registered at import
    # (the same recipe as tests/conftest.py)
    jax.config.update("jax_platforms", "cpu")

    jax.distributed.initialize(
        coordinator_address=args.coordinator,
        num_processes=args.num_processes,
        process_id=args.process_id)

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import __graft_entry__
    from metal_pathtracer.parallel import mesh as mesh_ops
    from metal_pathtracer.renderer.accumulation import RenderState
    from metal_pathtracer.renderer.frame import render_samples

    devices = jax.devices()
    n_dev = len(devices)
    assert n_dev >= args.num_processes, devices
    mesh = mesh_ops.make_mesh(devices)

    width, height = 16, 8 * n_dev
    scene, uniforms, static = __graft_entry__._build(width, height)

    # Host-local values -> global arrays: every process contributes only
    # its addressable shards (jax.device_put cannot place onto
    # non-addressable devices, so the single-process replicate/shard_state
    # helpers are wrapped here — the render path itself is unchanged).
    from jax.sharding import NamedSharding, PartitionSpec as P

    def global_put(x, spec):
        if x is None:
            return None
        x = np.asarray(x)
        sh = NamedSharding(mesh, spec)
        return jax.make_array_from_callback(x.shape, sh, lambda idx: x[idx])

    def global_tree(tree, spec=P()):
        return jax.tree_util.tree_map(lambda x: global_put(x, spec), tree)

    state = RenderState.create(width, height)
    specs = mesh_ops._state_specs()
    state_g = jax.tree_util.tree_map(
        lambda x, s: global_put(x, s), state, specs)

    out = mesh_ops.render_samples_sharded(
        global_tree(scene), global_tree(uniforms), state_g, static, 2,
        mesh, chunk=width * 8)

    # local single-device reference (no collectives)
    single = render_samples(scene, uniforms,
                            RenderState.create(width, height), static, 2)
    ref = np.asarray(single.radiance_sum)

    for shard in out.radiance_sum.addressable_shards:
        got = np.asarray(shard.data)
        want = ref[shard.index]
        if not np.array_equal(got, want):
            print(f"process {args.process_id}: shard {shard.index} "
                  f"mismatch (max diff {np.abs(got - want).max()})",
                  flush=True)
            return 1
    # psum'd counters are global totals on every process
    total = float(np.asarray(out.ray_count.addressable_data(0)))
    want_total = float(np.asarray(single.ray_count))
    if abs(total - want_total) > 0.5:
        print(f"process {args.process_id}: ray_count {total} != "
              f"{want_total}", flush=True)
        return 1

    print(f"DIST_DRYRUN_OK process={args.process_id} devices={n_dev}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
