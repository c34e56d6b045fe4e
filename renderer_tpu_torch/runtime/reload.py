"""Kernel live-reload (``renderer_tpu.runtime.reload``).

``KernelReloader`` watches the port's ``ops`` and ``passes`` modules and
its kernel sources (``csrc/*.cu``, the counterpart of the Pallas modules
the JAX reloader watches) by mtime. ``poll()``, once per frame between
frames (one stat per file):

- a changed ``.cu`` is rebuilt at once with nvcc into a new library (its
  name keyed by the source's hash);
- a changed ``.py`` module is reloaded; a kernel module gets its
  ``CudaLibrary`` and ``CudaKernel`` objects back from ``cuda_build``'s
  registry, so the objects chip_smoke and other modules hold stay the
  same (launch counts go on). ``cuda_build`` itself, which keeps that
  registry, is not watched;
- the plan builder is rebuilt (``rebuild()``; by default ``passes.pipeline``
  reloaded, since it binds the ops' functions by name), and a plan for
  the renderer's current switches is built and checked (``check_plan``:
  every pass reads what an earlier one writes).

Only when all of that succeeds does it swap: each rebuilt library takes
its new build in place (``CudaLibrary.adopt``: its kernels resolve their
functions there at the next launch) and the Renderer gets the new plan
builder, its plans cleared. On any failure (a Python error, an nvcc error, a plan that does not
check) the old plan and the old kernels keep rendering,
``stats["failures"]`` counts it and ``last_error`` says what it was; the
new mtimes are remembered, so the next edit tries again. Nothing falls
back to a plain version.
"""

from __future__ import annotations

import glob
import importlib
import os
from typing import Callable, Iterable, Optional

from renderer_tpu_torch.ops import cuda_build

PIPELINE = "renderer_tpu_torch.passes.pipeline"


def _default_watch_modules() -> list:
    import renderer_tpu_torch.ops as ops_pkg
    import renderer_tpu_torch.passes as passes_pkg

    mods = []
    for pkg in (ops_pkg, passes_pkg):
        pkg_dir = os.path.dirname(pkg.__file__)
        for fn in sorted(os.listdir(pkg_dir)):
            if fn.endswith(".py") and not fn.startswith("_") and fn != "cuda_build.py":
                mods.append(f"{pkg.__name__}.{fn[:-3]}")
    return mods


class KernelReloader:
    """Watches kernel modules and sources; hot-swaps the renderer's plan.

    renderer: ``runtime.Renderer`` (its ``plan_builder`` and plans).
    rebuild:  zero-argument callable returning a plan builder with
              ``build_forward_plan``'s signature (default: reload
              ``passes.pipeline``, return its ``build_forward_plan``).
    modules:  module names to watch (default: every ``ops`` and ``passes``
              module of the port).
    sources:  kernel source paths to watch (default: ``csrc/*.cu``).
    """

    def __init__(self, renderer, rebuild: Optional[Callable] = None,
                 modules: Optional[Iterable[str]] = None,
                 sources: Optional[Iterable[str]] = None):
        self.renderer = renderer
        self._rebuild = rebuild or self._default_rebuild
        self.modules = list(modules) if modules is not None else _default_watch_modules()
        self.sources = (list(sources) if sources is not None
                        else sorted(glob.glob(os.path.join(cuda_build.CSRC, "*.cu"))))
        self._mtimes = {k: self._mtime(k) for k in self.modules + self.sources}
        self.stats = {"reloads": 0, "failures": 0}
        self.last_error: Optional[str] = None

    @staticmethod
    def _default_rebuild() -> Callable:
        """``passes.pipeline`` reloaded (it binds the ops' functions by name)
        and its ``build_forward_plan``."""
        return importlib.reload(importlib.import_module(PIPELINE)).build_forward_plan

    def _mtime(self, key: str) -> float:
        path = key if key in self.sources else importlib.import_module(key).__file__
        try:
            return os.stat(path).st_mtime
        except OSError:
            return 0.0

    def changed(self) -> list:
        """Watched module names and source paths changed since the last poll."""
        return [k for k in self.modules + self.sources if self._mtime(k) != self._mtimes[k]]

    def poll(self) -> bool:
        """Rebuild what changed and hot-swap the plan. True when a swap
        happened."""
        changed = self.changed()
        if not changed:
            return False
        r = self.renderer
        try:
            rebuilt = []
            for src in (k for k in changed if k in self.sources):
                lib = cuda_build.LIBRARIES.get(os.path.abspath(src))
                if lib is not None:
                    new = cuda_build.CudaLibrary(lib.source)
                    new.load()  # nvcc now: a failed build raises here
                    rebuilt.append((lib, new))
            for name in (k for k in changed if k in self.modules):
                importlib.reload(importlib.import_module(name))
            builder = self._rebuild()
            plan = builder(r.cfg, r.outputs, r.light_casts, atlas_casts=r.atlas_casts,
                           **vars(r.config))
            importlib.import_module(PIPELINE).check_plan(plan, r.outputs, tuple(r.state))
        except Exception as e:  # keep the old plan and kernels rendering
            self.stats["failures"] += 1
            self.last_error = f"{type(e).__name__}: {e}"
            for k in changed:  # a broken save does not retrigger every frame
                self._mtimes[k] = self._mtime(k)
            return False
        for lib, new in rebuilt:
            lib.adopt(new)
        for k in changed:
            self._mtimes[k] = self._mtime(k)
        r.plan_builder = builder
        r.drop_plans()  # the plans and the programs captured from them
        self.stats["reloads"] += 1
        self.last_error = None
        return True
