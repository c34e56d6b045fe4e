"""The one directory of the port's compiled kernels and native libraries
(``renderer_tpu.utils.compile_cache``).

The JAX package persists XLA's compiled programs across process starts.
The port's compile cost is nvcc and g++ instead: ``ops/cuda_build.py``
and ``utils/native.py`` build each source into this directory under a
name keyed by a hash of the source (and the flags), so a later process
loads an unchanged library as it is. Both read the directory from here.
"""

from __future__ import annotations

import os

ENV_VAR = "RENDERER_TPU_COMPILE_CACHE"  # the JAX module's variable, honoured the same way
# the default build directory (git-ignored)
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")
_dir = None  # the directory, fixed by the first call


def enable_persistent_cache(cache_dir: str | None = None) -> str:
    """The build directory, made if need be. The first call fixes it:
    ``cache_dir``, else ``$RENDERER_TPU_COMPILE_CACHE``, else the git-ignored
    ``renderer_tpu_torch/_build/``; later calls return the same path."""
    global _dir
    if _dir is None:
        _dir = os.path.abspath(cache_dir or os.environ.get(ENV_VAR) or BUILD_DIR)
    os.makedirs(_dir, exist_ok=True)
    return _dir
