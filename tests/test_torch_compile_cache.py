"""The build directory of the port's kernels and native libraries
(renderer_tpu_torch/utils/compile_cache.py), on the CPU: one home that
``ops/cuda_build.py`` and ``utils/native.py`` both read, fixed by the
first call, honouring ``RENDERER_TPU_COMPILE_CACHE`` as the JAX module
does, and by default the git-ignored ``renderer_tpu_torch/_build/``."""

import os

from renderer_tpu_torch.ops import cuda_build
from renderer_tpu_torch.utils import compile_cache, native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_default_is_the_git_ignored_build_dir(monkeypatch):
    monkeypatch.setattr(compile_cache, "_dir", None)
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    d = compile_cache.enable_persistent_cache()
    assert d == os.path.join(ROOT, "renderer_tpu_torch", "_build") and os.path.isdir(d)
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert "renderer_tpu_torch/_build/" in f.read().split()


def test_idempotent_and_honours_the_variable(monkeypatch, tmp_path):
    monkeypatch.setattr(compile_cache, "_dir", None)
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path / "cache"))
    d = compile_cache.enable_persistent_cache()
    assert d == str(tmp_path / "cache") and os.path.isdir(d)
    # later calls, with or without a directory, return the first one
    assert compile_cache.enable_persistent_cache() == d
    assert compile_cache.enable_persistent_cache(str(tmp_path / "other")) == d
    assert not (tmp_path / "other").exists()


def test_builders_resolve_through_it(monkeypatch, tmp_path):
    monkeypatch.setattr(compile_cache, "_dir", None)
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    d = compile_cache.enable_persistent_cache(str(tmp_path / "explicit"))
    lib = cuda_build.CudaLibrary("probe.cu")
    assert os.path.dirname(lib.path) == d
    src = os.path.join(native.NATIVE_DIR, "arena.cc")
    assert os.path.dirname(native.library_path(src)) == d
    assert not hasattr(cuda_build, "BUILD_DIR") and not hasattr(native, "BUILD_DIR")
