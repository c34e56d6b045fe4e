"""A later cell, traffic mix or metric is data: a new traffic file, a new
workload file and a new metric reader dropped into a copy of the benchmark
run without an edit to any file that is there."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)

DRIVER = """
import json, sys, torch
import benchmark
assert benchmark.__file__.startswith(sys.argv[1]), benchmark.__file__
torch.set_num_threads(2)
from benchmark.harness import cell, spec
from benchmark.harness.traffic import Traffic
assert Traffic.moved_fields(spec.traffic("walk_two_movers")) == [
    "instances.translation", "lights.position"]
from benchmark.tests.tiny import tiny
line, _ = cell.run("envelope16x4096.walk_two_movers", 9, 0.5, False, 0.0, device="cpu", override=tiny)
print(json.dumps(line))
"""


def _digests(d):
    out = {}
    for base, _, files in os.walk(d):
        for f in files:
            if "__pycache__" not in base:
                p = os.path.join(base, f)
                out[os.path.relpath(p, d)] = hashlib.sha256(open(p, "rb").read()).hexdigest()
    return out


def test_new_workload_and_metric_files_run_unedited(tmp_path):
    copy = tmp_path / "benchmark"
    shutil.copytree(BENCH, copy, ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(copy)
    # a walk through three keys, two instances and a shaded light moving: a
    # camera path and motions that no committed traffic file uses
    walk = {
        "camera": {"path": "keys", "keys": [[-6.0, 3.0, 14.0, -0.4, -0.2],
                                             [6.0, 4.0, 12.0, 0.4, -0.3],
                                             [0.0, 8.0, -14.0, 3.1, -0.5]],
                   "frames_per_key": 5, "fov_y": 1.0, "near": 0.1, "far": 150.0},
        "motions": [
            {"field": "instances.translation", "rows": [2, 3], "center": [1.0, 2.0, 0.0],
             "amplitude": [3.0, 1.0, 3.0], "rate": [0.5, 0.9, 0.5], "phase": [0.0, 0.0, 1.0],
             "normalize": False},
            {"field": "lights.position", "rows": [0], "center": [0.2, -1.0, 0.1],
             "amplitude": [0.5, 0.0, 0.4], "rate": [0.3, 0.0, 0.2], "phase": [0.0, 0.0, 0.0],
             "normalize": True},
        ],
    }
    json.dump(walk, open(copy / "traffic" / "walk_two_movers.json", "w"))
    wl = json.load(open(copy / "workloads" / "envelope16x4096.light_orbit.json"))
    wl["traffic"] = "walk_two_movers"
    json.dump(wl, open(copy / "workloads" / "envelope16x4096.walk_two_movers.json", "w"))
    (copy / "metrics" / "frames_seen.py").write_text(
        '"""frames_seen: the frames the window completed."""\n\nUNIT = "frames"\n\n\n'
        "def read(run):\n    return run['frames']\n")
    out = subprocess.run([sys.executable, "-c", DRIVER, str(tmp_path)], capture_output=True,
                         text=True,
                         cwd=tmp_path, timeout=600,
                         env={**os.environ, "PYTHONPATH": f"{tmp_path}{os.pathsep}{ROOT}"})
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["metrics"]["frames_seen"] == {"value": line["attempted"], "unit": "frames"}
    after = _digests(copy)
    assert {k: v for k, v in after.items() if k in before} == before


def test_benchmark_json_names_files_that_agree():
    """Every cell of ``BENCHMARK.json`` has its workload file with the same
    configuration, traffic and chips, and its configuration's and traffic's
    files; every metric has its reader."""
    from benchmark.harness import spec

    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    for w in bench["workloads"]:
        wl = spec.workload(w["name"])
        assert (wl["config"], wl["traffic"], wl["chips"]) == (w["config"], w["traffic"], w["chips"])
        assert spec.config(wl["config"])["name"] == wl["config"]
        assert spec.traffic(wl["traffic"])["camera"]["path"] in ("orbit", "keys")
    readers = spec.metric_readers()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert readers[m["name"]].UNIT == m["unit"], m["name"]
