"""``jax.lax.cond``'s counterpart in the frame: ``cond(pred, body, prev)``.

Eagerly, on any device, it is ``torch.where(pred, body(), prev)``: the body
runs and the choice is made per element. Inside the capture of a frame
program (``runtime/program.py``) that has conditional nodes
(``conditional_nodes``), the body is captured into the body graph of a CUDA
graph conditional IF node (``csrc/graph_cond.cu``): at each replay a
one-thread kernel sets the node's handle from ``pred`` on the device, and
an unselected body launches nothing, as ``lax.cond`` skips its branch. The
body's result is then copied over a copy of ``prev``, so the value is the
eager one either way and ``prev`` is never written.

A capture without conditional nodes keeps ``torch.where`` inside the graph.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from renderer_tpu_torch.ops import cuda_build

LIBRARY = cuda_build.library("graph_cond.cu")
_PTR = ctypes.c_void_p
MIN_CUDA = (12, 4)  # cudaStreamBeginCaptureToGraph and conditional nodes
MAX_BODIES = 64  # conditional nodes per capture and device (one per shadow slot and shard)


def conditional_nodes() -> tuple:
    """(whether a capture can make conditional nodes here, why not)."""
    if not torch.cuda.is_available():
        return False, "no CUDA device"
    version = tuple(int(v) for v in (torch.version.cuda or "0.0").split(".")[:2])
    if version < MIN_CUDA:
        return False, f"CUDA runtime {torch.version.cuda} < {MIN_CUDA[0]}.{MIN_CUDA[1]}"
    if not hasattr(torch.cuda, "use_mem_pool"):
        return False, f"torch {torch.__version__} has no torch.cuda.use_mem_pool for the bodies"
    return True, ""


def _check(rc: int, what: str) -> None:
    if rc:
        raise RuntimeError(f"{what} failed: cudaError {rc}")


_STREAMS: dict = {}  # (device, use) -> a stream made for it


def own_stream(device, use: str) -> torch.cuda.ExternalStream:
    """The stream made for ``use`` on ``device``, made on first use with
    ``cudaStreamCreateWithFlags``: a stream from PyTorch's pool could be
    the one another capture is running on."""
    device = torch.empty(0, device=device).device  # "cuda" -> "cuda:0"
    stream = _STREAMS.get((device, use))
    if stream is None:
        handle = ctypes.c_void_p()
        with torch.cuda.device(device):
            _check(LIBRARY.function("rtt_stream_create", [ctypes.POINTER(ctypes.c_void_p)])(
                ctypes.byref(handle)), "rtt_stream_create")
        stream = _STREAMS[(device, use)] = torch.cuda.ExternalStream(handle.value, device=device)
    return stream


class Conditional:
    """What a capture's conditional nodes share on ``device`` (the nodes of
    every shard there, under a split frame): the stream their bodies are
    captured on (one per device, captures never overlap),
    the memory pool of the bodies' tensors (kept as long as the program),
    and per body its tally of runs on the device with the launches it
    counts per run."""

    def __init__(self, device):
        self.device = torch.empty(0, device=device).device
        self.stream = own_stream(self.device, "bodies")
        self.pool = None  # made at the first body
        # the bodies' run counts, made before the capture: a tensor the
        # capture allocates may reuse memory that the graph's earlier
        # nodes write at every replay
        self.tallies = torch.zeros(MAX_BODIES, dtype=torch.int64, device=self.device)
        self.bodies = []  # (tally, {kernel: launches per run})
        self._begin = LIBRARY.function("rtt_cond_begin",
                                       [_PTR, ctypes.POINTER(ctypes.c_void_p), _PTR])
        self._to_graph = LIBRARY.function("rtt_capture_to_graph", [_PTR, _PTR])
        self._end = LIBRARY.function("rtt_capture_end", [_PTR])
        _check(LIBRARY.function("rtt_cond_load", [])(), "rtt_cond_load")  # not inside a capture

    @contextlib.contextmanager
    def if_node(self, pred: torch.Tensor):
        """Capture what runs inside into the body of an IF node on ``pred``
        (a bool on the device) appended to the current stream's capture."""
        if len(self.bodies) == MAX_BODIES:
            raise ValueError(f"more than {MAX_BODIES} conditional nodes in one capture")
        pred = pred.to(torch.bool)
        stream = torch.cuda.current_stream(self.device)
        tally = self.tallies[len(self.bodies):len(self.bodies) + 1]
        body = ctypes.c_void_p()
        _check(self._begin(pred.data_ptr(), ctypes.byref(body), stream.cuda_stream),
               "rtt_cond_begin")
        before = cuda_build.launch_counts()
        if self.pool is None:
            self.pool = torch.cuda.MemPool()
        with torch.cuda.stream(self.stream), torch.cuda.use_mem_pool(self.pool, self.device):
            _check(self._to_graph(body, self.stream.cuda_stream), "rtt_capture_to_graph")
            try:
                yield
                tally.add_(1)
            finally:
                _check(self._end(self.stream.cuda_stream), "rtt_capture_end")
        after = cuda_build.launch_counts()
        self.bodies.append((tally, {k: after[k] - before.get(k, 0) for k in after
                                    if after[k] != before.get(k, 0)}))


# the Conditionals of the capture in progress by device ({}: none); a
# module global, so the shard threads of a split frame's capture see it
_ACTIVE: list = []


@contextlib.contextmanager
def capturing(conditionals: dict):
    """Within: ``cond`` makes conditional nodes through the Conditional of
    its predicate's device in ``conditionals`` (none there: it keeps
    ``torch.where``)."""
    _ACTIVE.append(conditionals)
    try:
        yield
    finally:
        _ACTIVE.pop()


def cond(pred: torch.Tensor, body, prev: torch.Tensor) -> torch.Tensor:
    """``body()`` where the 0-d bool ``pred`` holds, else ``prev`` (the
    shape of both)."""
    conditional = _ACTIVE[-1].get(pred.device) if _ACTIVE else None
    if conditional is None:
        return torch.where(pred, body(), prev)
    out = prev.clone()
    with conditional.if_node(pred):
        out.copy_(body())
    return out
