"""The output check fails what it must: the control (the reference in
bfloat16 in the program's place) and a run with the timed path broken
underneath, once for each fault a one-card frame stream can have. A tiny
run on the CPU, the card's look skipped; the frames go through the port's
eager path, where a function swapped into the plan takes effect."""

import pytest
import torch

from benchmark import control
from benchmark.harness import cell, check, spec
from benchmark.tests.tiny import tiny

CELL = "sponza10k.orbit_mover"
SEED = 5


def _run():
    torch.set_num_threads(2)
    return cell.run(CELL, SEED, 0.5, False, 0.0, device="cpu", override=tiny)[0]


def test_the_control_fails():
    torch.set_num_threads(2)
    per_frame = control.control_numbers(CELL, SEED, 6, torch.device("cpu"), override=tiny)
    ok, table = check.verdict(check.worst(per_frame), spec.workload(CELL)["limits"])
    assert not ok, table


def _state_unchanged(monkeypatch):
    """The atlas's step returns the state it was given."""
    import renderer_tpu_torch.passes.pipeline as pl

    def stale(*args, prev, **kw):
        return prev[0], prev
    monkeypatch.setattr(pl, "render_shadow_atlas_cached", stale)


def _half_left_out(monkeypatch):
    """The cull draws every other instance only."""
    import renderer_tpu_torch.passes.pipeline as pl
    real = pl.geometry.build_draw_stream

    def half(scene, prepared, *a, **kw):
        keep = torch.arange(prepared.visible.shape[0], device=prepared.visible.device) % 2 == 0
        return real(scene, prepared._replace(visible=prepared.visible & keep), *a, **kw)
    monkeypatch.setattr(pl.geometry, "build_draw_stream", half)


def _image_altered(monkeypatch):
    """One pixel of the image altered where shading produces it."""
    import renderer_tpu_torch.passes.pipeline as pl
    real = pl.shade_pbr

    def altered(*a, **kw):
        img = real(*a, **kw).clone()
        img[3, 5] += 0.01
        return img
    monkeypatch.setattr(pl, "shade_pbr", altered)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_left_out, _image_altered],
                         ids=lambda f: f.__name__.strip("_"))
def test_a_broken_frame_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    line = _run()
    assert line["correct"] is False and line["failed"] >= 1, line["checks"]
