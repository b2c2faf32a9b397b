"""RNG bit-compatibility tests.

The PCG hash and seed recipe must match the reference bit-for-bit
(reference: shaders/pathtrace.metal:55-64, 9735-9740) — sharding-invariant
determinism depends on it (SURVEY.md §5.8).
"""

import numpy as np
import jax.numpy as jnp

from metal_pathtracer.ops import rng


def ref_pcg_hash(state: int) -> int:
    """Pure-python uint32 replica of the reference hash."""
    state = (state * 747796405 + 2891336453) & 0xFFFFFFFF
    word = (((state >> ((state >> 28) + 4)) ^ state) * 277803737) & 0xFFFFFFFF
    return ((word >> 22) ^ word) & 0xFFFFFFFF


def test_pcg_hash_matches_scalar_model():
    states = np.array([0, 1, 42, 1337, 0xFFFFFFFF, 123456789], np.uint32)
    got = np.asarray(rng.pcg_hash(jnp.asarray(states)))
    want = np.array([ref_pcg_hash(int(s)) for s in states], np.uint32)
    np.testing.assert_array_equal(got, want)


def test_rand_uniform_in_range_and_deterministic():
    state = jnp.arange(1024, dtype=jnp.uint32)
    s1, v1 = rng.rand_uniform(state)
    s2, v2 = rng.rand_uniform(state)
    np.testing.assert_array_equal(np.asarray(s1), np.asarray(s2))
    np.testing.assert_array_equal(np.asarray(v1), np.asarray(v2))
    v = np.asarray(v1)
    assert (v >= 0.0).all() and (v < 1.0).all()


def test_seed_recipe():
    # seed = fixed + frame*9781 + x*6271 + y*13007 + (sample+prev)*211
    x = jnp.asarray([3], jnp.uint32)
    y = jnp.asarray([7], jnp.uint32)
    prev = jnp.asarray([2], jnp.uint32)
    got = int(np.asarray(rng.make_seed(1337, 5, x, y, 2, prev))[0])
    want = (1337 + 5 * 9781 + 3 * 6271 + 7 * 13007 + (2 + 2) * 211) & 0xFFFFFFFF
    assert got == want


def test_unit_disk_masked_rejection():
    state = jnp.arange(4096, dtype=jnp.uint32)
    new_state, p = rng.random_in_unit_disk(state)
    r2 = np.asarray((p ** 2).sum(-1))
    assert (r2 < 1.0).all()
    # Lanes must advance their state (they all drew at least once)
    assert not np.array_equal(np.asarray(new_state), np.asarray(state))


def test_unit_disk_matches_sequential_model():
    """Each lane's accepted point must equal a sequential rejection loop."""
    def scalar_disk(seed):
        s = seed
        while True:
            s = ref_pcg_hash(s)
            r1 = np.float32(s) / np.float32(2 ** 32)
            s = ref_pcg_hash(s)
            r2 = np.float32(s) / np.float32(2 ** 32)
            p = (2.0 * np.array([r1, r2], np.float64) - 1.0).astype(np.float32)
            if float(p[0] ** 2 + p[1] ** 2) < 1.0:
                return s, p

    seeds = np.array([1, 99, 2024, 777777], np.uint32)
    new_state, pts = rng.random_in_unit_disk(jnp.asarray(seeds))
    for i, seed in enumerate(seeds):
        s_want, p_want = scalar_disk(int(seed))
        assert int(np.asarray(new_state)[i]) == s_want
        np.testing.assert_allclose(np.asarray(pts)[i], p_want, rtol=1e-6)


def test_cosine_hemisphere_distribution():
    state = jnp.arange(1 << 14, dtype=jnp.uint32)
    _, d = rng.sample_cosine_hemisphere(state)
    d = np.asarray(d)
    norms = np.linalg.norm(d, axis=-1)
    np.testing.assert_allclose(norms, 1.0, atol=1e-5)
    # E[cos theta] for cosine-weighted sampling = 2/3
    assert abs(d[:, 2].mean() - 2.0 / 3.0) < 0.01
