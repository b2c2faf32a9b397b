"""Traversal route choice, the no-fallback backend rule, the compile cache
placement and the native build stamp."""

import os

import jax
import numpy as np
import pytest

from metal_pathtracer.ops import traversal
from metal_pathtracer.scene.resources import Material, SceneResources
from metal_pathtracer.utils.procgen import dragon_class_scene_mesh


def _resources():
    res = SceneResources()
    res.add_material(Material())
    res.add_mesh(dragon_class_scene_mesh(1, material=0))
    return res


def test_default_route_is_xla_on_cpu():
    assert jax.default_backend() == "cpu"
    assert traversal.default_route() == "xla"
    scene = _resources().build_arrays()
    assert scene.tri_kernel is None


def test_default_route_is_kernel_on_gpu(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert traversal.default_route() == "kernel"


def test_cpu_default_device_inside_gpu_process_takes_xla(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    with jax.default_device(jax.devices("cpu")[0]):
        assert traversal.default_route() == "xla"


@pytest.mark.parametrize("route", ["kernel", "interpret"])
def test_interpret_only_when_asked(route):
    res = _resources()
    res.add_mesh_instance(res.meshes[0], np.eye(4))
    scene = res.build_arrays(traversal=route)
    want = route == "interpret"
    assert scene.tri_kernel.interpret is want
    assert all(g.tri_kernel.interpret is want for g in scene.instanced)


def test_xla_route_builds_no_kernel_tables():
    res = _resources()
    res.add_mesh_instance(res.meshes[0], np.eye(4))
    scene = res.build_arrays(traversal="xla")
    assert scene.tri_kernel is None
    assert all(g.tri_kernel is None for g in scene.instanced)


def test_unknown_route_is_an_error():
    with pytest.raises(ValueError, match="traversal route"):
        _resources().build_arrays(traversal="packet")


def test_jax_backend_forwards_route(monkeypatch):
    from metal_pathtracer.renderer import headless
    from metal_pathtracer.settings import RenderSettings

    seen = []
    real = SceneResources.build_arrays

    def spy(self, environment=None, textures=None, traversal=None):
        seen.append(traversal)
        return real(self, environment, textures, traversal)

    monkeypatch.setattr(SceneResources, "build_arrays", spy)
    headless.JaxBackend("xla").render(_resources(), RenderSettings(), 8, 8, 1)
    assert seen == ["xla"]


def test_gpu_backend_needs_a_gpu_or_an_explicit_cpu(monkeypatch):
    from metal_pathtracer.renderer import headless

    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    assert isinstance(headless.make_backend("gpu"), headless.JaxBackend)
    monkeypatch.delenv("JAX_PLATFORMS")
    with pytest.raises(RuntimeError, match="no GPU"):
        headless.make_backend("gpu")
    assert isinstance(headless.make_backend("cpu-jax"),
                      headless.CpuJaxBackend)


def test_compile_cache_uses_env_dir_verbatim(monkeypatch, tmp_path):
    from metal_pathtracer.utils import compilecache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compilecache.enable_cache() == str(tmp_path)
    # JAX reads the variable itself; nothing in code overrides it
    assert jax.config.jax_compilation_cache_dir == before
    assert os.listdir(tmp_path) == []


def test_compile_cache_default_is_repo_dir(monkeypatch):
    from metal_pathtracer.utils import compilecache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        got = compilecache.enable_cache()
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert got == os.path.join(repo, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == got
        assert os.path.isdir(got)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_native_stamp_tracks_sources(tmp_path):
    from metal_pathtracer.utils import nativebuild

    (tmp_path / "a.cpp").write_text("int f() { return 1; }\n")
    (tmp_path / "build.sh").write_text("true\n")
    h1 = nativebuild.source_hash(str(tmp_path))
    assert nativebuild.source_hash(str(tmp_path)) == h1
    (tmp_path / "a.cpp").write_text("int f() { return 2; }\n")
    assert nativebuild.source_hash(str(tmp_path)) != h1
    (tmp_path / "b.c").write_text("int g;\n")
    h3 = nativebuild.source_hash(str(tmp_path))
    (tmp_path / "notes.txt").write_text("not a source")
    assert nativebuild.source_hash(str(tmp_path)) == h3


def test_native_stale_library_is_rebuilt(monkeypatch):
    from metal_pathtracer.utils import nativebuild

    path = nativebuild.ensure_built("libbvh_builder.so")
    if path is None:
        pytest.skip("no C++ compiler")
    assert nativebuild._stamp_matches()
    calls = []
    monkeypatch.setattr(nativebuild, "_stamp_matches",
                        lambda: bool(calls))
    monkeypatch.setattr(nativebuild, "_attempted", False)
    real_run = nativebuild.subprocess.run

    def run(*a, **k):
        calls.append(a)
        return real_run(*a, **k)

    monkeypatch.setattr(nativebuild.subprocess, "run", run)
    assert nativebuild.ensure_built("libbvh_builder.so") == path
    assert len(calls) == 1
