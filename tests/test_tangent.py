"""Tangent generation: vendored MikkTSpace vs the UV-derivative fallback.

The reference vendors MikkTSpace as the tangent authority
(reference: src/assets/TangentGen.mm:8-10, external/MikkTSpace/) — glTF
normal mapping is defined against it. VERDICT r01 missing #2.
"""

import numpy as np
import pytest

from metal_pathtracer.scene import tangent


def quad_mesh():
    # unit quad in the XY plane, +Z normal, UVs aligned with X/Y
    positions = np.asarray([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]],
                           np.float32)
    normals = np.tile(np.asarray([0, 0, 1], np.float32), (4, 1))
    uvs = np.asarray([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    faces = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)
    return positions, normals, uvs, faces


def test_mikktspace_available():
    out = tangent.generate_tangents_mikktspace(*quad_mesh())
    assert out is not None, "vendored MikkTSpace failed to build/load"


def test_mikktspace_known_vectors():
    out = tangent.generate_tangents_mikktspace(*quad_mesh())
    assert out is not None
    # UVs increase with +X: tangent must be +X with +1 handedness
    np.testing.assert_allclose(out[:, :3],
                               np.tile([1.0, 0.0, 0.0], (4, 1)), atol=1e-5)
    np.testing.assert_allclose(out[:, 3], np.ones(4), atol=1e-6)


def test_mikktspace_unit_and_orthogonal():
    rng = np.random.default_rng(3)
    # bumpy grid mesh with nontrivial normals
    n = 8
    gx, gy = np.meshgrid(np.linspace(0, 1, n), np.linspace(0, 1, n))
    z = 0.1 * np.sin(gx * 6) * np.cos(gy * 5)
    positions = np.stack([gx, gy, z], -1).reshape(-1, 3).astype(np.float32)
    uvs = np.stack([gx, gy], -1).reshape(-1, 2).astype(np.float32)
    faces = []
    for j in range(n - 1):
        for i in range(n - 1):
            a = j * n + i
            faces += [[a, a + 1, a + n + 1], [a, a + n + 1, a + n]]
    faces = np.asarray(faces, np.int32)
    # area-weighted vertex normals
    normals = np.zeros_like(positions)
    fn = np.cross(positions[faces[:, 1]] - positions[faces[:, 0]],
                  positions[faces[:, 2]] - positions[faces[:, 0]])
    for c in range(3):
        np.add.at(normals, faces[:, c], fn)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)

    out = tangent.generate_tangents_mikktspace(positions, normals, uvs, faces)
    assert out is not None
    t = out[:, :3]
    np.testing.assert_allclose(np.linalg.norm(t, axis=1), 1.0, atol=1e-4)
    # MikkTSpace tangents are orthogonal to the vertex normal
    assert np.abs((t * normals).sum(-1)).max() < 1e-4
    assert set(np.unique(out[:, 3])) <= {-1.0, 1.0}

    # fallback agreement: same field up to MikkTSpace's angular tolerance
    fb = tangent.generate_tangents_fallback(positions, normals, uvs, faces)
    cos = (t * fb[:, :3]).sum(-1)
    assert cos.min() > 0.98, f"fallback diverges: min cos {cos.min()}"
    np.testing.assert_array_equal(out[:, 3], fb[:, 3])


def test_default_prefers_mikktspace():
    mesh = quad_mesh()
    out = tangent.generate_tangents(*mesh)
    mk = tangent.generate_tangents_mikktspace(*mesh)
    if mk is None:
        pytest.skip("native mikktspace unavailable")
    np.testing.assert_array_equal(out, mk)
