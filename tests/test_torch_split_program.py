"""The split frame's program (``runtime/program.py`` over a mesh of
shards): the JAX Renderer's one program per plan under ``spmd_mesh``, a
CUDA graph per shard and stretch between collectives on the card.

On the CPU ``Renderer(..., spmd_mesh=mesh, replay=True)`` runs the same
static buffers without a capture (one static scene, camera and clock per
device; each shard's state buffers written in place), so everything but
the capture is held here, bit for bit against the eager split frame
(``replay=False``) over three frames: n2, n8, the shadowed dynamic tier
(the cached atlas carried across frames, the mover shifted), freeze
through the two-frame latch, checkerboard+fix, rt, occlusion culling and
the HUD (the eager tail gathers the rows). Also: a checkpoint round trip
and a same-layout ``state`` assignment write into the shards' buffers; a
scene swapped for another of the same shapes re-uses the program; the
capture's hooks in ``run_shards`` (a segment per stretch between
collectives, in turns, every exchanged value and result kept); and two
shadowed dynamic frames against the JAX ``Renderer(spmd_mesh=...)`` on
two CPU devices (Pallas in interpret mode) at
``test_split_frame_matches_jax_spmd``'s bar for shadowed frames: the
visible (instance, library triangle) equal on >= 99.9% of pixels,
display-clamped PSNR >= 40 dB. Sizes are ``tests/test_torch_parallel.py``'s
(128x256, ``OPTS``).

The card tests (``-m gpu``, skipped without a CUDA device): the replayed
split frame over two shards of the card equals the eager split frame and
the replayed single frame bit for bit in chip_smoke phase 40's four tiers
at 256x128, its launches are counted per replay, and a capture that fails
raises:

    python -m pytest tests/test_torch_split_program.py -m gpu -q
"""

import dataclasses

import numpy as np
import pytest
import torch

from renderer_tpu_torch.mathx import Camera, orbit_camera
from renderer_tpu_torch.parallel import make_mesh, run_shards
from renderer_tpu_torch.passes.pipeline import PipelineConfig
from renderer_tpu_torch.runtime import Renderer
from renderer_tpu_torch.runtime.checkpoint import load_renderer, save_renderer
from renderer_tpu_torch.runtime.program import Segments
from renderer_tpu_torch.utils import tree
from test_torch_program import assert_same

# tests/test_torch_parallel.py's size, options and camera (that module
# imports the JAX package, which the card's machine lacks: its scene is
# imported where a CPU test needs it)
WIDTH, HEIGHT = 128, 256
OPTS = dict(tri_capacity=8192, shadow_slots=2, shadow_size=128)
CAM = dict(position=[0.0, 1.2, 4.0], fov_y=0.9, near=0.1, far=60.0)
DYNAMIC = dict(shadow_update_budget=1, shadow_progressive=2)
MOVER = 1  # the instance the dynamic frames move

# name -> (shards, config changes, switches, frames move the mover)
CASES = {
    "n2": (2, {}, {}, False),
    "n8": (8, {}, {}, False),
    "n2_shadowed_dynamic": (2, DYNAMIC, dict(shadows=True), True),
    "n8_shadowed_dynamic": (8, DYNAMIC, dict(shadows=True), True),
    "n8_freeze": (8, {}, dict(freeze_culling=True), False),
    "n8_checkerboard": (8, dict(shade_rate="checkerboard"), {}, False),
    "n8_rt": (8, {}, dict(rt=True), False),
    "n2_occlusion": (2, {}, dict(occlusion_culling=True), False),
    "n2_hud": (2, {}, dict(hud=True), False),
}


def cam(k: int) -> Camera:
    return Camera.create(**{**CAM, "position": [0.1 * k, 1.2, 4.0]}, device="cpu")


def moved(scene, k: int):
    """``scene`` with instance MOVER shifted by k steps: another scene
    object of the same shapes."""
    inst = scene.instances
    shift = torch.zeros_like(inst.translation)
    shift[MOVER, 0] = 0.25 * k
    return scene._replace(instances=inst._replace(translation=inst.translation + shift))


@pytest.fixture(scope="module")
def scene():
    from test_torch_parallel import small_scene

    return small_scene()


def pair(scene, shards, changes=None, switches=None, latch=False):
    """An eager and a program split Renderer over ``shards`` CPU shards;
    the switches taken up at once, or after the next frame with
    ``latch``."""
    cfg = PipelineConfig(**{**dict(width=WIDTH, height=HEIGHT, **OPTS), **(changes or {})},
                         spmd_devices=shards)
    out = []
    for replay in (False, True):
        r = Renderer(scene, cfg, spmd_mesh=make_mesh(["cpu"] * shards), replay=replay)
        r.set_config(**(switches or {}))
        if not latch:
            r.apply_config_now()
        out.append(r)
    return out


def lockstep(eager, program, frames, what: str) -> None:
    """Render ``frames`` (kwargs of ``render`` per frame) through both: the
    outputs, every shard's outputs and the state equal after each."""
    for k, kw in enumerate(frames):
        a, b = eager.render(**kw), program.render(**kw)
        assert_same(a, b, f"{what}: frame {k} outputs")
        assert_same(eager.shard_outputs, program.shard_outputs, f"{what}: frame {k} shards")
        assert_same(eager.state, program.state, f"{what}: frame {k} state")


def buffer_ids(r) -> list:
    return [id(v) for st in r.shard_states for v in tree.leaves(st)]


@pytest.mark.parametrize("name", sorted(CASES))
def test_program_split_frames_equal_eager(scene, name):
    shards, changes, switches, move = CASES[name]
    latch = "freeze_culling" in switches  # freeze keeps a culled frame's list
    eager, program = pair(scene, shards, changes, switches, latch=latch)
    overlay = None
    if "hud" in switches:
        from renderer_tpu_torch.ops.overlay import hud_overlay

        overlay = hud_overlay("SPLIT", WIDTH)
    before = buffer_ids(program)
    lockstep(eager, program, [dict(camera=cam(k), scene=moved(scene, k) if move else None,
                                   overlay=overlay) for k in range(3)], name)
    assert buffer_ids(program) == before  # the frames wrote into the shards' buffers
    assert len(program.programs) == (2 if latch else 1)
    assert program.stats["compiles"] == 0  # nothing captured on the CPU


def test_checkpoint_and_state_assignment_write_into_the_buffers(scene, tmp_path):
    eager, program = pair(scene, 2, DYNAMIC, dict(shadows=True))
    lockstep(eager, program, [dict(camera=cam(k)) for k in range(2)], "before the checkpoint")
    for name, r in (("eager", eager), ("program", program)):
        save_renderer(str(tmp_path / name), r)
    lockstep(eager, program, [dict(camera=cam(2), scene=moved(scene, 1))], "after the checkpoint")
    buffers = buffer_ids(program)
    for name, r in (("eager", eager), ("program", program)):
        load_renderer(str(tmp_path / name), r)
    assert buffer_ids(program) == buffers  # copied into them
    assert_same(eager.state, program.state, "restored")
    lockstep(eager, program, [dict(camera=cam(k)) for k in (2, 3)], "restored")
    # a state of the same layout assigned: copied into the buffers
    fresh = Renderer(scene, program.cfg, spmd_mesh=program.spmd_mesh, replay=False).state
    for r in (eager, program):
        r.state = fresh
    assert buffer_ids(program) == buffers
    assert_same(fresh, program.state, "assigned")
    assert torch.equal(program.shard_states[1]["vis"].depth, fresh["vis"].depth[HEIGHT // 2:])
    lockstep(eager, program, [dict(camera=cam(4))], "after the assignment")
    assert len(program.programs) == 1


def test_swapped_scene_of_the_same_shapes_reuses_the_program(scene):
    eager, program = pair(scene, 2)
    lockstep(eager, program, [dict(camera=cam(0), scene=moved(scene, k)) for k in range(4)],
             "swapped scene")
    assert len(program.programs) == 1


class RecordedSegments(Segments):
    """``Segments`` whose segments are recorded, not captured."""

    def __init__(self, devices):
        super().__init__(devices)
        self.calls = []

    def begin(self, shard):
        self.calls.append(("begin", shard))
        self._open[shard] = object(), None

    def end(self, shard):
        self.calls.append(("end", shard))
        self.graphs.append((shard, self._open.pop(shard)[0]))


def test_run_shards_cuts_segments_at_the_collectives():
    """Each shard's segments bracket its work between collectives, one
    shard's open at a time, in turns; every exchanged value and every
    result is kept; ``steps`` groups the k-th segments of all shards."""
    n = 3
    mesh = make_mesh(["cpu"] * n)
    segments = RecordedSegments(mesh.devices)

    def fn(s):
        i = s.axis_index()
        x = torch.full((2,), float(i))
        total = s.psum(x)
        rows = s.halo_rows(torch.arange(8.0).reshape(4, 2) + i)
        return s.all_gather(total + rows[0][0])

    out = run_shards(mesh, fn, segments=segments)
    # psum 3; the row above: shard 0's own first, else the last of the shard above
    want = torch.tensor([[3.0, 4.0], [9.0, 10.0], [10.0, 11.0]])
    assert all(torch.equal(o, want) for o in out)
    # 3 collectives: 4 segments per shard, one open at a time, in turns
    assert segments.calls == [(kind, i) for _ in range(4) for i in range(n)
                              for kind in ("begin", "end")]
    assert [len(step) for step in segments.steps()] == [n] * 4
    # kept: each collective's values once (when all shards read them), and
    # each shard's result of it
    assert len(segments.kept) == 3 + 3 * n


def test_steps_refuse_shards_that_crossed_different_collectives():
    segments = Segments(("cpu", "cpu"))
    segments.graphs = [(0, "a"), (1, "b"), (0, "c")]
    with pytest.raises(RuntimeError, match="different numbers of collectives"):
        segments.steps()
    segments.graphs.append((1, "d"))
    assert segments.steps() == [[("cpu", "a"), ("cpu", "b")], [("cpu", "c"), ("cpu", "d")]]


def test_shadowed_dynamic_split_program_matches_jax_spmd(scene):
    """Two shadowed dynamic frames (the mover shifted on the second)
    through the program over two CPU shards and through the JAX Renderer
    over two CPU devices."""
    import jax
    import jax.numpy as jnp

    from renderer_tpu.mathx.camera import Camera as JaxCamera
    from renderer_tpu.parallel import make_mesh as jax_make_mesh
    from renderer_tpu.passes.pipeline import PipelineConfig as JaxConfig
    from renderer_tpu.runtime import Renderer as JaxRenderer
    from renderer_tpu.utils.image import psnr
    from test_parallel import small_scene as jax_small_scene
    from test_torch_parallel import visible_identity

    outputs = ("image", "vis", "soup")
    opts = dict(width=WIDTH, height=HEIGHT, tri_capacity=8192, shadow_slots=2, shadow_size=128,
                spmd_devices=2, **DYNAMIC)
    r = Renderer(scene, PipelineConfig(**opts), outputs=outputs,
                 spmd_mesh=make_mesh(["cpu"] * 2), replay=True)
    jscene = jax_small_scene()
    jr = JaxRenderer(jscene, JaxConfig(use_pallas=True, pallas_interpret=True, shading="pbr",
                                       **opts),
                     outputs=outputs, spmd_mesh=jax_make_mesh(jax.devices()[:2]))
    for x in (r, jr):
        x.set_config(shadows=True)
        x.apply_config_now()
    for k in range(2):
        jinst = jscene.instances
        js = jscene._replace(instances=jinst._replace(
            translation=jinst.translation.at[MOVER, 0].add(0.25 * k)))
        got = r.render(cam(k), scene=moved(scene, k))
        want = jr.render(JaxCamera.create(jnp.asarray([0.1 * k, 1.2, 4.0]), fov_y=0.9, near=0.1,
                                          far=60.0), scene=js)
        got_id, want_id = got["vis"].tri_id.numpy(), np.asarray(want["vis"].tri_id)
        assert 0.2 < (got_id >= 0).mean() < 1.0
        same = visible_identity(got["soup"], got_id) == visible_identity(want["soup"], want_id)
        assert same.mean() >= 0.999, f"frame {k}: visible triangle differs on {(~same).sum()}"
        img = got["image"].numpy()
        assert img.shape == (HEIGHT, WIDTH, 3) and np.isfinite(img).all()
        assert psnr(np.clip(img, 0, 1), np.clip(np.asarray(want["image"]), 0, 1)) >= 40.0, k
    assert len(r.programs) == 1


# -- on the card -------------------------------------------------------------

# chip_smoke phase 40's tiers: name -> (config changes, switches)
CARD_TIERS = {
    "base_exact": ({}, {}),
    "base_checkerboard_fix": (dict(shade_rate="checkerboard"), {}),
    "shadowed_static_checkerboard_fix": (dict(shade_rate="checkerboard"), dict(shadows=True)),
    "rt": ({}, dict(rt=True)),
}
CARD_CFG = PipelineConfig(width=256, height=128, tri_capacity=8192, aa="edge", trilinear=False,
                          shadow_size=256)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def card_renderers(name, devices):
    """The eager split, replayed split and replayed single Renderers of a
    tier on ``devices``, the switches taken up."""
    from renderer_tpu_torch.models import sponza_like_scene

    dev = torch.device(devices[0])
    changes, switches = CARD_TIERS[name]
    scene = sponza_like_scene(256, device=dev)
    cfg = dataclasses.replace(CARD_CFG, **changes)
    split_cfg = dataclasses.replace(cfg, spmd_devices=len(devices))
    out = [Renderer(scene, split_cfg, spmd_mesh=make_mesh(devices), replay=False),
           Renderer(scene, split_cfg, spmd_mesh=make_mesh(devices)),
           Renderer(scene, cfg, device=dev)]
    for r in out:
        r.set_config(**switches)
        r.apply_config_now()
    assert out[1].replay and out[2].replay and not out[0].replay
    return out


def card_lockstep(renderers, frames: int = 4):
    dev = renderers[0].device
    aspect = CARD_CFG.width / CARD_CFG.height
    for k in range(frames):
        eager, split, single = (r.render(orbit_camera(0.3 + 0.01 * k, aspect, dev))
                                for r in renderers)
        torch.cuda.synchronize()
        assert_same(eager, split, f"frame {k}: replayed split against eager split")
        assert_same(renderers[0].state, renderers[1].state, f"frame {k}: state")
        assert_same(single, split, f"frame {k}: replayed split against replayed single")


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(CARD_TIERS))
def test_replayed_split_equals_eager_split_on_the_card(name):
    _card()
    renderers = card_renderers(name, ["cuda:0"] * 2)
    card_lockstep(renderers)
    split = renderers[1]
    assert split.stats["compiles"] == 1
    (program,) = split.programs.values()
    assert program.graphs and len(program.graphs) % 2 == 0  # a segment per shard and stretch


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(CARD_TIERS))
def test_replayed_split_across_cards(name):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    card_lockstep(card_renderers(name, [f"cuda:{i}" for i in range(
        min(4, torch.cuda.device_count()))]))


@pytest.mark.gpu
def test_replayed_split_launches():
    """Kernel 1 runs once per shard and frame, kernel 2 once per shard and
    rt frame, the replays counted (1 eager frame + capture, 4 replays)."""
    from renderer_tpu_torch.ops import occlusion_cuda, raster_cuda

    _card()
    for name, want_occlusion in (("base_exact", 0), ("rt", 10)):
        _, split, _ = card_renderers(name, ["cuda:0"] * 2)
        aspect = CARD_CFG.width / CARD_CFG.height
        raster_cuda.RASTER_TILES.launches = 0
        occlusion_cuda.OCCLUSION_TILES.launches = 0
        for k in range(5):
            split.render(orbit_camera(0.3 + 0.01 * k, aspect, split.device))
        assert raster_cuda.RASTER_TILES.launches == 10, name
        assert occlusion_cuda.OCCLUSION_TILES.launches == want_occlusion, name
        assert split.stats["compiles"] == 1


FAILED_CAPTURE = """
import sys
sys.path[:0] = ["tests", "."]
import torch
from renderer_tpu_torch.mathx import orbit_camera
from test_torch_split_program import CARD_CFG, card_lockstep, card_renderers

renderers = card_renderers("base_exact", ["cuda:0"] * 2)
split = renderers[1]
build = split.plan_builder

def syncing_plan(*args, **kw):
    passes = build(*args, **kw)
    i = next(i for i, p in enumerate(passes) if p.name == "shade")
    fn = passes[i].fn

    def shade(**a):
        out = fn(**a)
        float(next(iter(out.values())).sum())  # waits for the card
        return out

    passes[i] = passes[i]._replace(fn=shade)
    return passes

split.plan_builder = syncing_plan
try:
    split.render(orbit_camera(0.3, CARD_CFG.width / CARD_CFG.height, torch.device("cuda:0")))
except RuntimeError as e:
    print("raised:", type(e).__name__)
assert not any(p.graphs for p in split.programs.values())
split.plan_builder = build
split.drop_plans()
card_lockstep(renderers, frames=3)
for name in ("rt", "shadowed_static_checkerboard_fix"):
    card_lockstep(card_renderers(name, ["cuda:0"] * 2), frames=3)
print("recovered")
"""


@pytest.mark.gpu
def test_a_failed_capture_raises():
    """A pass that waits for the card runs in the eager first frame and
    breaks the capture after it: render raises, no program is kept
    captured, and the process captures and replays split frames after it
    (in a child process, so a fault there cannot take this one down)."""
    import os
    import subprocess
    import sys

    _card()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    done = subprocess.run([sys.executable, "-c", FAILED_CAPTURE], cwd=root, capture_output=True,
                          text=True, timeout=600)
    assert done.returncode == 0, done.stdout[-2000:] + done.stderr[-4000:]
    assert "raised:" in done.stdout and "recovered" in done.stdout
