"""Build a CUDA source of ``csrc/`` with nvcc and load it with ctypes.

Each source is a shared library with a plain C interface, compiled for
Hopper (``sm_90a``) at first use into ``renderer_tpu_torch/_build/``
(git-ignored) under a name keyed by a hash of the source and the flags, so
an edited source is rebuilt and an unchanged one is loaded as it is.
Nothing is built when a module is imported. ``start()`` runs nvcc in the
background, so several sources can build at once (``build_all``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
# -fmad=false: no FMA contraction, so a kernel rounds every product and sum
# as its plain PyTorch version does; -Xptxas -v reports registers and spills
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
    "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v",
)


class CudaLibrary:
    """One ``csrc/<source>`` built into a shared library. ``build_log``
    holds the build time and ptxas's register/shared-memory report (empty
    when the library was already built)."""

    def __init__(self, source: str):
        self.source = os.path.join(CSRC, source)
        self.build_log = ""
        self._path = None
        self._proc = None
        self._lib = None

    def _lib_path(self) -> str:
        if self._path is None:
            with open(self.source, "rb") as f:
                digest = hashlib.sha256(f.read() + repr(NVCC_FLAGS).encode()).hexdigest()[:16]
            stem = os.path.splitext(os.path.basename(self.source))[0]
            self._path = os.path.join(BUILD_DIR, f"lib{stem}-{digest}.so")
        return self._path

    def start(self) -> None:
        """Start nvcc unless the library exists or is being built."""
        path = self._lib_path()
        if self._lib is not None or self._proc is not None or os.path.exists(path):
            return
        from torch.utils.cpp_extension import CUDA_HOME

        if CUDA_HOME is None:
            raise RuntimeError(f"nvcc not found: the CUDA toolkit is needed to build {self.source}")
        os.makedirs(BUILD_DIR, exist_ok=True)
        self._tmp = f"{path}.tmp{os.getpid()}"
        self._t0 = time.perf_counter()
        self._proc = subprocess.Popen(
            [os.path.join(CUDA_HOME, "bin", "nvcc"), *NVCC_FLAGS, self.source, "-o", self._tmp],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )

    def load(self) -> ctypes.CDLL:
        """The loaded library, built first if need be."""
        if self._lib is None:
            self.start()
            if self._proc is not None:
                _, err = self._proc.communicate()
                rc, self._proc = self._proc.returncode, None
                if rc != 0:
                    raise RuntimeError(f"nvcc failed on {self.source}:\n{err}")
                os.replace(self._tmp, self._lib_path())
                self.build_log = f"built in {time.perf_counter() - self._t0:.2f} s\n{err}"
            self._lib = ctypes.CDLL(self._lib_path())
        return self._lib

    def function(self, name: str, argtypes: list):
        """A C function of the library returning an int (a cudaError_t)."""
        fn = getattr(self.load(), name)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
        return fn


def build_all(libraries) -> None:
    """Build several libraries at once: one nvcc each, all started together."""
    for lib in libraries:
        lib.start()
    for lib in libraries:
        lib.load()


def ptxas_summary(lib: CudaLibrary) -> str:
    """The register / spill lines of a build log, joined on one line."""
    return " ".join(ln.strip() for ln in lib.build_log.splitlines()
                    if "registers" in ln or "spill" in ln)
