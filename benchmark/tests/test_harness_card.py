"""On the card: one short run of the first cell through ``run.py``, its
result line whole and correct."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.mark.gpu
def test_a_short_run_on_the_card(cuda_card):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "sponza10k.orbit_mover", "--seed", "4294967311", "--seconds", "2",
                          "--trace", "0"], capture_output=True, text=True, cwd=ROOT, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    assert {"frame_ms", "frame_p95_ms", "peak_mem_gib", "setup_s"} <= set(line["metrics"])
