"""bench_torch.py, the port's timing entry point, against bench.py.

- ``result_line`` gives bench.result_line's dict on every branch input of
  tests/test_bench.py, the platform suffix of the metric aside;
- its constants, gate poses, camera, scripted caster, ``psnr_min`` and
  ``psnr_vs_golden`` are bench.py's (the camera within float32 rounding of
  the quaternion product, the PSNRs within 1e-9 dB);
- ``main`` runs on the CPU at a tiny size (64 instances, 128x64, 2 frames,
  2 bands, 128x128 shadow slots, capacities 2048) and prints, as its last
  line, one JSON object with bench.result_line's key set and a ``_cpu``
  metric.
"""

import collections
import contextlib
import io
import json
import math

import numpy as np
import pytest
import torch

import bench
import bench_torch
from renderer_tpu_torch.utils.image import read_png

# the branch inputs of tests/test_bench.py: (args, keyword args)
BRANCHES = {
    "gate_pass": (("tpu", 100967.0), dict(dt=0.02991, cb_dt=0.02621, cb_psnr=41.0)),
    "gate_fail": (("tpu", 100967.0), dict(dt=0.02991, cb_dt=0.02621, cb_psnr=39.9)),
    "mtris_fast": (("tpu", 1e5), dict(dt=0.030, cb_dt=0.025, cb_psnr=45.0)),
    "mtris_slow": (("tpu", 1e5), dict(dt=0.030, cb_dt=0.025, cb_psnr=10.0)),
    "shadowed_gate": (("tpu", 1e5), dict(dt=0.030, cb_dt=0.025, cb_psnr=45.0, sh_dt=0.040,
                                         sh_cb_dt=0.031, sh_psnr=41.5)),
    "shadowed_fail": (("tpu", 1e5), dict(dt=0.030, cb_dt=0.025, cb_psnr=45.0, sh_dt=0.040,
                                         sh_cb_dt=0.031, sh_psnr=20.0)),
    "dynamic_promoted": (("tpu", 1e5), dict(dt=0.030, cb_dt=0.025, cb_psnr=45.0, sh_dt=0.040,
                                            sh_cb_dt=0.030, sh_psnr=41.0, dyn_dt=1.0 / 31.0,
                                            dyn_updates=1.2)),
    "dynamic_slow": (("tpu", 1e5), dict(dt=0.030, cb_dt=0.025, cb_psnr=45.0, sh_dt=0.040,
                                        sh_cb_dt=0.030, sh_psnr=41.0, dyn_dt=1.0 / 20.0,
                                        dyn_updates=0.8)),
    "dynamic_gate_fail": (("tpu", 1e5), dict(dt=0.030, cb_dt=0.025, cb_psnr=45.0, sh_dt=0.040,
                                             sh_cb_dt=0.030, sh_psnr=35.0, dyn_dt=1.0 / 40.0,
                                             dyn_updates=1.0)),
    "golden": (("tpu", 1e5), dict(dt=0.030, cb_dt=0.025, cb_psnr=45.0, golden_psnr=31.27)),
    "golden_missing": (("tpu", 1e5), dict(dt=0.030, cb_dt=0.025, cb_psnr=45.0,
                                          golden_psnr=-1.0)),
}


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_result_line_matches_bench(branch):
    (platform, tris), kw = BRANCHES[branch]
    want = bench.result_line(platform, tris, **kw)
    got = bench_torch.result_line("gpu", tris, **kw)
    assert got.pop("metric") == want.pop("metric")[: -len(platform)] + "gpu"
    assert got == want
    json.dumps(got)


def test_constants_camera_and_caster_match_bench():
    for name in ("WIDTH", "HEIGHT", "N_INSTANCES", "TRI_CAPACITY", "FRAMES", "TARGET_FPS",
                 "GATE_DB", "SHADOW_PROGRESSIVE", "SHADOW_BAND_CAPACITY",
                 "PROMOTE_SHADOWED_FPS", "MOVER_INSTANCE", "GATE_ANGLES"):
        assert getattr(bench_torch, name) == getattr(bench, name), name
    assert bench_torch.gate_angles(bench.FRAMES) == bench.GATE_ANGLES
    for a in (0.3, 0.59, 1.7):
        got, want = bench_torch.make_camera(a, device="cpu"), bench.make_camera(a)
        for f in ("position", "rotation", "fov_y", "aspect", "near", "far"):
            np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                       rtol=0, atol=1e-7, err_msg=f)
    # the scripted caster: bench._mover_scene's table for each frame
    table = np.random.default_rng(0).normal(size=(6, 3)).astype(np.float32)
    inst = collections.namedtuple("Instances", "translation")
    scene = collections.namedtuple("Scene", "instances")
    ks = (-3, 0, 7)
    got = bench_torch.mover_tables(scene(inst(torch.from_numpy(table))), ks, "cpu").numpy()
    for i, k in enumerate(ks):
        want = bench._mover_scene(scene(inst(table)), table, float(k)).instances.translation
        np.testing.assert_allclose(got[i], want, rtol=0, atol=1e-6)


def test_psnr_functions_match_bench(monkeypatch):
    rng = np.random.default_rng(1)
    a = {g: rng.uniform(size=(8, 16, 3)).astype(np.float32) for g in bench.GATE_ANGLES}
    b = {g: np.clip(v + rng.normal(scale=0.01, size=v.shape), 0, 1).astype(np.float32)
         for g, v in a.items()}
    assert math.isclose(bench_torch.psnr_min(a, b), bench.psnr_min(a, b), abs_tol=1e-9)
    assert bench_torch.psnr_min(a, a) == bench.psnr_min(a, a) == 120.0
    # against the committed goldens, at their own size
    gold = {g: read_png(f"{bench_torch.GOLDEN_DIR}/shadowed_pose{i}.png") / 255.0
            for i, g in enumerate(bench.GATE_ANGLES)}
    near = {g: np.clip(v + rng.normal(scale=0.02, size=v.shape), 0, 1).astype(np.float32)
            for g, v in gold.items()}
    monkeypatch.chdir(bench_torch.ROOT)
    want = bench.psnr_vs_golden(near)
    assert 20.0 < want < 60.0
    assert math.isclose(bench_torch.psnr_vs_golden(near), want, abs_tol=1e-9)
    small = {g: v[:8, :8] for g, v in near.items()}
    assert bench_torch.psnr_vs_golden(small) == bench.psnr_vs_golden(small) == -1.0


TINY = ["--device", "cpu", "--instances", "64", "--width", "128", "--height", "64", "--frames",
        "2", "--bands", "2", "--shadow-size", "128", "--tri-capacity", "2048",
        "--band-capacity", "2048"]


def test_main_runs_tiny_on_the_cpu():
    out = io.StringIO()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite's workers share the host's cores
    try:
        with contextlib.redirect_stdout(out):
            rc = bench_torch.main(TINY)
    finally:
        torch.set_num_threads(threads)
    assert rc == 0
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    want = bench.result_line("tpu", 1.0, 0.03, 0.025, 45.0, 0.04, 0.03, 41.0, dyn_dt=0.05,
                             dyn_updates=1.0)
    assert set(line) == set(want)  # no golden key: the goldens are 1920x1088
    assert line["metric"] == "sponza_like_64inst_128x64_fps_cpu"
    assert line["value"] > 0 and line["visible_triangles"] > 0
    assert line["shadow_progressive_bands"] == 2 and line["shadow_caster_capacity"] == 2048
    assert 0 < line["shadow_updates_per_frame"] <= 1
    assert line["shadowed_shadow_updates_per_frame"] == 0.0
