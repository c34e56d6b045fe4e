"""Profiling and frame statistics (``renderer_tpu.utils.profiling``).

- ``trace(log_dir)``: a ``torch.profiler`` window over host and card that
  exports a Chrome trace (open it in Perfetto or chrome://tracing). The
  Renderer already wraps every pass in a ``forward.<pass>`` range, so the
  trace shows per-pass spans. The JAX package's ``dump_hlo`` has no
  counterpart: there is no compiled graph; the nearest thing is the ptxas
  report of each kernel build (``ops.cuda_build.CudaLibrary.build_log``).
- ``FrameStats``: rolling per-frame wall times and the fps figures of the
  HUD.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str = None):
    """Profile the block (CPU, and CUDA when there is a card); on exit
    write ``<log_dir>/trace.json`` (default: a directory in the temporary
    directory). Yields the log directory."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "renderer_tpu_torch_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class FrameStats:
    """Rolling frame-time statistics over the last ``window`` frames."""

    def __init__(self, window: int = 120):
        self.window = window
        self.samples: list[float] = []
        self._last = None

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self.samples.append(now - self._last)
            if len(self.samples) > self.window:
                self.samples.pop(0)
        self._last = now

    def summary(self) -> dict:
        if not self.samples:
            return {"fps": 0.0, "ms_avg": 0.0, "ms_p99": 0.0}
        s = sorted(self.samples)
        avg = sum(s) / len(s)
        p99 = s[min(len(s) - 1, int(len(s) * 0.99))]
        return {"fps": 1.0 / avg if avg > 0 else 0.0, "ms_avg": avg * 1e3, "ms_p99": p99 * 1e3}
