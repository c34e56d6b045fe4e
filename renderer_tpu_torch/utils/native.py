"""Build a C++ source with a plain C interface into a shared library, by
path, with g++ at first use.

The library goes to the build directory of ``utils/compile_cache.py`` (by
default the git-ignored ``renderer_tpu_torch/_build/``) under a name keyed
by a hash of the source, so an edited source is rebuilt and an unchanged
one is loaded as it is. The JAX package's native sources
(``renderer_tpu/native/*.cc``) are shared this way: compiled by path, not
imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

from renderer_tpu_torch.utils.compile_cache import enable_persistent_cache

NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__)))), "renderer_tpu", "native")
_lock = threading.Lock()


def library_path(src: str) -> str:
    """Where the library of ``src`` is built: its name keyed by a hash of the source."""
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    stem = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(enable_persistent_cache(), f"lib{stem}-{digest}.so")


def load_shared(src: str) -> ctypes.CDLL:
    """The library built from ``src`` (built first if need be)."""
    with _lock:
        lib_path = library_path(src)
        if not os.path.exists(lib_path):
            tmp = f"{lib_path}.tmp{os.getpid()}"
            subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-std=c++17", src, "-o", tmp],
                           check=True, capture_output=True)
            os.replace(tmp, lib_path)  # atomic: concurrent builders race safely
        return ctypes.CDLL(lib_path)
