"""Byte-pinned golden: the deterministic smoke render's exact PPM bytes.

The analogue of the reference's published smoke pin (reference:
paper/paper.md:183-189 — 64x64x4spp PPM, size 66,925 bytes, pinned sha256).
Ours pins the 48x48x2spp CPU-path smoke render through the REAL CLI
surface, so any silent numeric drift anywhere in the pipeline (RNG,
integrator, tonemap, writer) fails this test.

Update policy: if a change is *intended* to alter the image (new sampling
logic, fixed bug), re-run `python tests/test_golden_pinned.py` to print the
new hash, update GOLDEN below, and say why in the commit message. Never
update it to green an unintended diff.
"""

import hashlib
import os

import pytest

SCENE = """\
camera target=0,0,-1 distance=3.5 yaw=0 pitch=0 vfov=45 defocusAngle=0.0 focusDist=3.5
renderer samplesPerFrame=1 maxDepth=4 seed=1337
background solid=0.7,0.8,1.0
material type=lambert albedo=0.8,0.3,0.3
material type=lambert albedo=0.8,0.8,0.0
sphere center=0,0,-1 radius=0.5 material=0
sphere center=0,-100.5,-1 radius=100 material=1
"""

# Pinned on jax-CPU (the tests/ conftest platform). 48x48, 2 spp, seed 1337.
GOLDEN_SIZE = 6925
GOLDEN_SHA256 = \
    "2b8aa54666d282531dd19a22be7c98cee44c8296168406d606289c2e6d6b2a64"


def _render(tmpdir: str) -> bytes:
    from metal_pathtracer import cli

    scene_path = os.path.join(tmpdir, "smoke.scene")
    out_path = os.path.join(tmpdir, "smoke.ppm")
    with open(scene_path, "w") as fh:
        fh.write(SCENE)
    rc = cli.main([
        "--scene", scene_path, "--width", "48", "--height", "48",
        "--spp", "2", "--seed", "1337", "--backend", "cpu-jax",
        "--format", "ppm", "--output", out_path,
    ])
    assert rc == 0
    with open(out_path, "rb") as fh:
        return fh.read()


def test_smoke_ppm_bytes_pinned(tmp_path):
    if GOLDEN_SHA256 is None:
        pytest.skip("golden not pinned yet")
    data = _render(str(tmp_path))
    assert len(data) == GOLDEN_SIZE, (
        f"smoke PPM size drifted: {len(data)} != {GOLDEN_SIZE}")
    digest = hashlib.sha256(data).hexdigest()
    assert digest == GOLDEN_SHA256, (
        f"smoke PPM bytes drifted: sha256 {digest} != {GOLDEN_SHA256}; "
        "if the change is intentional, follow the update policy in this "
        "file's docstring")


if __name__ == "__main__":
    import sys
    import tempfile

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    with tempfile.TemporaryDirectory() as td:
        data = _render(td)
    print(f"GOLDEN_SIZE = {len(data)}")
    print(f"GOLDEN_SHA256 = \"{hashlib.sha256(data).hexdigest()}\"")
