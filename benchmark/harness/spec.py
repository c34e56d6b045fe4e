"""What the harness finds by name: a cell's workload file, its
configuration file, its traffic file, and the metric readers under
``benchmark/metrics/``.

- ``benchmark/workloads/<cell>.json``: ``config`` (a configuration's name),
  ``traffic`` (a traffic mix's name), ``chips`` and ``limits`` (the output
  check's limit per compared number).
- ``benchmark/configs/<config>.json``: the scene, the pipeline settings,
  the runtime switches, the precision, the guarantees.
- ``benchmark/traffic/<traffic>.json``: the camera path and the scene's
  motions (``harness/traffic.py`` says the keys).
- ``benchmark/metrics/<metric>.py``: ``UNIT`` and ``read(run)``, the
  metric's value from a run's record, or None when the run has nothing
  to read.

``BENCHMARK.json`` at the checkout's root, when present, says which
metrics a cell reports; without it every reader is asked.
"""

from __future__ import annotations

import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def workload(name: str, bench_dir: str = BENCH_DIR) -> dict:
    path = os.path.join(bench_dir, "workloads", f"{name}.json")
    if not os.path.exists(path):
        raise SystemExit(f"benchmark: no workload {name!r} ({path})")
    return _load_json(path)


def config(name: str, bench_dir: str = BENCH_DIR) -> dict:
    path = os.path.join(bench_dir, "configs", f"{name}.json")
    if not os.path.exists(path):
        raise SystemExit(f"benchmark: no configuration {name!r} ({path})")
    return _load_json(path)


def traffic(name: str, bench_dir: str = BENCH_DIR) -> dict:
    path = os.path.join(bench_dir, "traffic", f"{name}.json")
    if not os.path.exists(path):
        raise SystemExit(f"benchmark: no traffic {name!r} ({path})")
    return _load_json(path)


def metric_readers(bench_dir: str = BENCH_DIR) -> dict:
    """name -> module of every file under ``metrics/``."""
    out = {}
    mdir = os.path.join(bench_dir, "metrics")
    for fname in sorted(os.listdir(mdir)):
        if not fname.endswith(".py") or fname.startswith("_"):
            continue
        name = fname[:-3]
        spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}",
                                                      os.path.join(mdir, fname))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[name] = mod
    return out


def cell_metrics(cell: str, traced: bool, readers: dict, root: str = ROOT) -> list:
    """The metric names a run of ``cell`` reports: its end-to-end metrics
    untraced, its per-layer metrics traced, as ``BENCHMARK.json`` lists
    them (a metric with ``workloads`` only in those cells); every reader
    when there is no ``BENCHMARK.json``."""
    path = os.path.join(root, "BENCHMARK.json")
    if not os.path.exists(path):
        return sorted(readers)
    bench = _load_json(path)
    group = bench["per_layer"] if traced else bench["end_to_end"]
    return [m["name"] for m in group if cell in m.get("workloads", [cell])]
