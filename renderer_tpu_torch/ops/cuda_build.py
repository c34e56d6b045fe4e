"""Build a CUDA source of ``csrc/`` with nvcc, load it with ctypes, and
launch its C functions.

Each source is a shared library with a plain C interface, compiled for
Hopper (``sm_90a``) at first use into the build directory of
``utils/compile_cache.py`` (by default the git-ignored
``renderer_tpu_torch/_build/``) under a name keyed by a hash of the source and the flags, so
an edited source is rebuilt and an unchanged one is loaded as it is.
Nothing is built when a module is imported. ``start()`` runs nvcc in the
background, so several sources can build at once (``build_all``).

Every kernel wrapper launches through ``CudaKernel`` and checks its inputs
with ``check_inputs``: the one launch path of the package. A kernel module
makes its library with ``library()`` and its kernels with
``CudaLibrary.kernel``; both are kept in ``LIBRARIES``, so a reloaded
module gets the same objects back, and the kernel reloader
(``runtime/reload.py``) rebuilds a library in place (``adopt``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
import weakref

import torch

from renderer_tpu_torch.utils.compile_cache import enable_persistent_cache
from renderer_tpu_torch.utils.profiling import host_span

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
# -fmad=false: no FMA contraction, so a kernel rounds every product and sum
# as its plain PyTorch version does; -Xptxas -v reports registers and spills
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
    "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v",
)
# every library made by ``library()``, by the source's absolute path
LIBRARIES: dict = {}


def library(source: str) -> "CudaLibrary":
    """The library of ``csrc/<source>`` (or of a path), made on first use
    and the same object on every later call."""
    lib = CudaLibrary(source)
    return LIBRARIES.setdefault(os.path.abspath(lib.source), lib)


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
        self._lock = threading.Lock()  # the shards of a split frame may load it at once
        self.kernels = []  # every CudaKernel made over this library

    def kernel(self, symbol: str, argtypes: list) -> "CudaKernel":
        """The library's kernel ``symbol``, made on first use; a later call
        (a reloaded module) gets the same object with these ``argtypes``."""
        for k in self.kernels:
            if k.symbol == symbol:
                k.argtypes, k._fn = [*argtypes, ctypes.c_void_p], None
                return k
        return CudaKernel(self, symbol, argtypes)

    def adopt(self, new: "CudaLibrary") -> None:
        """Take ``new``'s build of the same source, rebuilt after an edit:
        each kernel resolves its function there at its next launch."""
        self._path, self._lib, self.build_log = new._path, new._lib, new.build_log
        for k in self.kernels:
            k._fn = None

    @property
    def path(self) -> str:
        """The shared library's path (built or not)."""
        return self._lib_path()

    def _lib_path(self) -> str:
        if self._path is None:
            with open(self.source, "rb") as f:
                digest = hashlib.sha256(f.read() + repr(NVCC_FLAGS).encode()).hexdigest()[:16]
            stem = os.path.splitext(os.path.basename(self.source))[0]
            self._path = os.path.join(enable_persistent_cache(), f"lib{stem}-{digest}.so")
        return self._path

    def start(self) -> None:
        """Start nvcc unless the library exists or is being built."""
        path = self._lib_path()
        if self._lib is not None or self._proc is not None or os.path.exists(path):
            return
        from torch.utils.cpp_extension import CUDA_HOME

        if CUDA_HOME is None:
            raise RuntimeError(f"nvcc not found: the CUDA toolkit is needed to build {self.source}")
        self._tmp = f"{path}.tmp{os.getpid()}"
        self._t0 = time.perf_counter()
        self._proc = subprocess.Popen(
            [os.path.join(CUDA_HOME, "bin", "nvcc"), *NVCC_FLAGS, self.source, "-o", self._tmp],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )

    def load(self) -> ctypes.PyDLL:
        """The loaded library, built first if need be. Its functions are
        called with the GIL held: they only enqueue work, and keeping the
        GIL is cheaper than releasing it around the call."""
        with self._lock:
            if self._lib is None:
                self.start()
                if self._proc is not None:
                    with host_span(f"nvcc {os.path.basename(self.source)}"):
                        _, err = self._proc.communicate()
                    rc, self._proc = self._proc.returncode, None
                    if rc != 0:
                        raise RuntimeError(f"nvcc failed on {self.source}:\n{err}")
                    os.replace(self._tmp, self._lib_path())
                    self.build_log = f"built in {time.perf_counter() - self._t0:.2f} s\n{err}"
                self._lib = ctypes.PyDLL(self._lib_path())
        return self._lib

    def function(self, name: str, argtypes: list):
        """A C function of the library returning an int (a cudaError_t)."""
        fn = getattr(self.load(), name)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
        return fn


class CudaKernel:
    """One launch function of a library, ``int symbol(args..., void*
    stream)`` returning a cudaError_t. The function is resolved once, at
    the first launch. Each launch passes PyTorch's current stream of the
    device, looked up anew every time (through ``torch.accelerator``, the
    cheapest public route to its handle), raises if the function returns
    an error, and adds one to ``launches``.

    A captured frame program (``runtime/program.py``) does not call the
    function at a replay: it adds its capture's launches with ``count``,
    and those inside a conditional node's body through a tally on the
    device (``add_tally``), which reading or setting ``launches`` adds in
    (a device read: it waits for the card)."""

    def __init__(self, library: CudaLibrary, symbol: str, argtypes: list):
        self.library = library
        self.symbol = symbol
        self.argtypes = [*argtypes, ctypes.c_void_p]
        self._launches = 0
        self._fn = None
        library.kernels.append(self)

    @property
    def launches(self) -> int:
        settle_tallies()
        return self._launches

    @launches.setter
    def launches(self, n: int) -> None:
        settle_tallies()
        self._launches = n

    def count(self, n: int) -> None:
        """Add ``n`` launches made without a call of the function (a replay)."""
        self._launches += n

    def load(self):
        if self._fn is None:
            with host_span(f"CudaKernel.load {self.symbol}"):
                self._fn = self.library.function(self.symbol, self.argtypes)
        return self._fn

    def launch(self, device_index: int, *args) -> None:
        rc = (self._fn or self.load())(*args, torch.accelerator.current_stream(device_index).native_handle)
        if rc:
            raise RuntimeError(f"{self.symbol} failed: cudaError {rc}")
        self._launches += 1


def all_kernels() -> list:
    """Every CudaKernel of every library made so far."""
    return [k for lib in LIBRARIES.values() for k in lib.kernels]


def launch_counts() -> dict:
    """Each kernel's launches counted on the host so far (no device read)."""
    return {k: k._launches for k in all_kernels()}


# (a weak reference to a (1,) int64 tally on the device, {kernel: launches
# per run}): the conditional bodies of captured programs, each tally the
# runs of its body (the program holds the tally); _RETIRED holds the
# tallies of dropped programs until they are read
_TALLIES: list = []
_RETIRED: list = []
_BODY_RUNS = [0]  # conditional bodies run, over every tally settled so far


def add_tally(tally: torch.Tensor, per_run: dict) -> None:
    """Count ``per_run`` launches of each kernel per run of a conditional
    body; ``tally`` (zeroed) is the body's run count, added to on the
    device."""
    _TALLIES.append((weakref.ref(tally), per_run))


def retire_tallies(tallies) -> None:
    """Keep ``tallies`` (of a dropped program) until the next read."""
    _RETIRED.extend(tallies)


def settle_tallies() -> None:
    """Add the runs counted on the device to ``launches`` and zero the
    tallies (a device read); forget those no program holds."""
    if not _TALLIES and not _RETIRED:
        return
    retired = {id(t) for t, _ in _RETIRED}
    _TALLIES[:] = [(r, p) for r, p in _TALLIES if r() is not None and id(r()) not in retired]
    for tally, per_run in [(r(), p) for r, p in _TALLIES] + _RETIRED:
        runs = int(tally.sum())
        if runs:
            tally.zero_()
            _BODY_RUNS[0] += runs
            for kernel, n in per_run.items():
                kernel._launches += runs * n
    _RETIRED.clear()


def body_runs() -> int:
    """Conditional bodies run on the devices so far, every program's (a
    device read, as ``settle_tallies``)."""
    settle_tallies()
    return _BODY_RUNS[0]


def check_inputs(kernel: str, *specs) -> int:
    """The CUDA device index of the inputs. Raise ValueError unless each
    (tensor, dtype, shape) of ``specs`` is a contiguous CUDA tensor of that
    dtype and shape (None: any shape) on the first tensor's device."""
    index = specs[0][0].get_device()
    for t, dtype, shape in specs:
        if (not t.is_cuda or t.dtype is not dtype or t.get_device() != index
                or (shape is not None and t.shape != shape) or not t.is_contiguous()):
            raise ValueError(f"{kernel} kernel input: want a contiguous {dtype} "
                             f"{'tensor' if shape is None else tuple(shape)} on the same CUDA "
                             f"device, got {t.dtype} {tuple(t.shape)} on {t.device}")
    return index


def build_all(libraries) -> None:
    """Build several libraries at once: one nvcc each, all started together."""
    with host_span("cuda_build.build_all"):
        for lib in libraries:
            lib.start()
        for lib in libraries:
            lib.load()


def ptxas_summary(lib: CudaLibrary) -> str:
    """The register / spill lines of a build log, joined on one line."""
    return " ".join(ln.strip() for ln in lib.build_log.splitlines()
                    if "registers" in ln or "spill" in ln)
