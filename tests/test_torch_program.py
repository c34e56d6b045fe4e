"""The frame program (``runtime/program.py``): one plan's frame over static
buffers, replayed as one CUDA graph on the card, against the eager frame.

On the CPU the program runs the plan over the same static buffers without
a capture (``Renderer(replay=True)``), so everything but the capture is
held here, bit for bit against the eager Renderer (``replay=False``) over
four frames of each case: the externals copied in (a moving camera, the
animation clock, a scene object swapped for another of the same shapes),
the donated state (the cached atlas with a slot selected on one frame and
unselected on the next, freeze culling through the two-frame latch, a
checkpoint round trip), the outputs copied out (a returned frame is not
overwritten by the next), the programs dropped by a reload, and ``cond``'s
eager form. The shadowed dynamic frames are also held against the JAX
Renderer (Pallas in interpret mode) with the shadow-frame tests' bars:
the visible triangle equal on >= 99.9% of pixels and display-clamped PSNR
>= 40 dB.

The card tests (``-m gpu``, skipped without a CUDA device): the replayed
frame equals the eager one bit for bit in every captured tier at a small
size (the shadowed tiers' replays through conditional nodes against the
eager frames' ``torch.where``), ``launches`` counts replays, and the
conditional node skips an
unselected atlas slot (no kernel launched, the atlas unchanged) and runs a
selected one:

    python -m pytest tests/test_torch_program.py -m gpu -q
"""

import dataclasses
import os
import sys
import time

import numpy as np
import pytest
import torch

from renderer_tpu_torch.mathx import Camera, orbit_camera
from renderer_tpu_torch.models import skinned_scene, sponza_like_scene, textured_scene
from renderer_tpu_torch.ops import control, raster_cuda
from renderer_tpu_torch.passes.pipeline import PipelineConfig, build_forward_plan
from renderer_tpu_torch.runtime import KernelReloader, Renderer
from renderer_tpu_torch.runtime.checkpoint import load_renderer, save_renderer
from renderer_tpu_torch.scene import SceneLimits
from renderer_tpu_torch.utils import tree

W, H = 64, 32
CFG = PipelineConfig(width=W, height=H, tri_capacity=512, aa="edge", enable_normal_maps=True,
                     trilinear=False, shadow_size=128)
# the dynamic tier's cache, one band of two per frame, on the one slot of
# the scene's sun (an empty slot's units are dirty once too)
DYNAMIC = dict(shadow_update_budget=1, shadow_progressive=2, shadow_slots=1)
MOVER = 1  # the instance the shadowed cases move


def cam(k: int, aspect: float = W / H) -> Camera:
    return Camera.create([0.15 * k, 1.2, 4.0], fov_y=0.9, near=0.1, far=60.0, aspect=aspect,
                         device="cpu")


def moved(scene, k: int):
    """``scene`` with instance MOVER shifted by k steps: another scene
    object of the same shapes."""
    inst = scene.instances
    shift = torch.zeros_like(inst.translation)
    shift[MOVER, 0] = 0.25 * k
    return scene._replace(instances=inst._replace(translation=inst.translation + shift))


def pair(scene, cfg=CFG, **switches):
    """An eager and a program Renderer of ``scene``, the switches taken up."""
    out = []
    for replay in (False, True):
        r = Renderer(scene, cfg, replay=replay)
        r.set_config(**switches)
        r.apply_config_now()
        out.append(r)
    return out


def assert_same(a: dict, b: dict, what: str) -> None:
    la, sa = tree.flatten(a)
    lb, sb = tree.flatten(b)
    assert repr(sa) == repr(sb), what
    for x, y in zip(la, lb):
        assert torch.equal(torch.nan_to_num(x, nan=7.0), torch.nan_to_num(y, nan=7.0)), what


def lockstep(eager, program, frames, what: str):
    """Render ``frames`` (kwargs of ``render`` per frame) through both; the
    outputs and the state equal after every frame. Returns the program's
    outputs."""
    outs = []
    for k, kw in enumerate(frames):
        a, b = eager.render(**kw), program.render(**kw)
        assert_same(a, b, f"{what}: frame {k} outputs")
        assert_same(eager.state, program.state, f"{what}: frame {k} state")
        outs.append(b)
    return outs


@pytest.fixture(scope="module")
def scene():
    return textured_scene(SceneLimits.tiny(), 32, device="cpu")


def test_base_frames_and_returned_frames_are_kept(scene):
    eager, program = pair(scene)
    outs = lockstep(eager, program, [dict(camera=cam(k)) for k in range(4)], "base")
    kept = [o["image"].clone() for o in outs]
    assert all(torch.equal(o["image"], k) for o, k in zip(outs, kept))
    assert not torch.equal(kept[0], kept[1])
    assert len(program.programs) == 1 and program.stats["compiles"] == 0  # nothing captured here
    # the state's buffers stay the same tensors: the frames wrote into them
    before = [id(v) for v in tree.leaves(program._state)]
    program.render(cam(5))
    assert [id(v) for v in tree.leaves(program._state)] == before


def test_shadowed_dynamic_cache_selects_and_skips(scene):
    """Frames: the first band of the first shadowed frame, the second band,
    then nothing dirty (no unit selected), then the mover shifted (a band
    selected again)."""
    cfg = dataclasses.replace(CFG, **DYNAMIC)
    eager, program = pair(scene, cfg, shadows=True)
    scenes = [scene, scene, scene, moved(scene, 1)]
    updates = []
    for k, s in enumerate(scenes):
        sig_before = program.state["shadow_cache"][1].clone()
        lockstep(eager, program, [dict(camera=cam(k), scene=s)], f"dynamic frame {k}")
        sig = program.state["shadow_cache"][1]
        updates.append(int((torch.nan_to_num(sig, 7.0) != torch.nan_to_num(sig_before, 7.0))
                           .any(dim=-1).sum()))
    assert updates == [1, 1, 0, 1], updates


def test_shadowed_dynamic_frames_match_jax():
    """Three shadowed dynamic frames (the mover shifted on the third)
    through the program and through the JAX Renderer, both in the plain
    configuration (its compile is the shorter) at 128x64, the JAX raster's
    width. The JAX package is imported here: the card's machine has none,
    and this file's card tests run there."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from renderer_tpu.mathx.camera import Camera as JaxCamera
    from renderer_tpu.models import textured_scene as jax_textured
    from renderer_tpu.passes.pipeline import PipelineConfig as JaxConfig
    from renderer_tpu.runtime import Renderer as JaxRenderer
    from renderer_tpu.scene import SceneLimits as JaxLimits
    from renderer_tpu.utils.image import psnr
    from test_torch_pipeline import visible_identity

    w, h = 128, 64
    opts = dict(width=w, height=h, tri_capacity=2048, aa="edge", enable_normal_maps=True,
                trilinear=False, shadow_size=128, **DYNAMIC)
    outputs = ("image", "vis", "soup")
    port_scene = textured_scene(SceneLimits.tiny(), 32, device="cpu")
    jscene = jax_textured(JaxLimits.tiny(), 32)
    r = Renderer(port_scene, PipelineConfig(tile_raster=False, **opts), outputs=outputs,
                 replay=True)
    jr = JaxRenderer(jscene, JaxConfig(shading="pbr", use_pallas=False, **opts), outputs=outputs)
    for x in (r, jr):
        x.set_config(shadows=True)
        x.apply_config_now()
    for k in range(3):
        jinst = jscene.instances
        js = jscene._replace(instances=jinst._replace(
            translation=jinst.translation.at[MOVER, 0].add(0.25 * (k == 2))))
        got = r.render(cam(k, w / h), scene=moved(port_scene, int(k == 2)))
        want = jr.render(JaxCamera.create(jnp.asarray([0.15 * k, 1.2, 4.0]), fov_y=0.9,
                                          near=0.1, far=60.0, aspect=w / h), scene=js)
        got_id = got["vis"].tri_id.numpy()
        want_id = np.asarray(want["vis"].tri_id)
        assert 0.2 < (got_id >= 0).mean() < 1.0
        same = visible_identity(got, got_id) == visible_identity(want, want_id)
        assert same.mean() >= 0.999, f"frame {k}: visible triangle differs on {(~same).sum()}"
        img = np.clip(got["image"].numpy(), 0, 1)
        assert psnr(img, np.clip(np.asarray(want["image"]), 0, 1)) >= 40.0, k


def test_freeze_through_the_latch(scene):
    eager, program = pair(scene)
    for r in (eager, program):
        r.set_config(freeze_culling=True)  # taken up after the next frame
    lockstep(eager, program, [dict(camera=cam(k)) for k in range(4)], "freeze")
    assert program.config.freeze_culling and len(program.programs) == 2


def test_skinning_clock():
    eager, program = pair(skinned_scene(device="cpu"), dataclasses.replace(CFG, skinning=True))
    outs = lockstep(eager, program, [dict(camera=cam(0), time_s=0.1 * k) for k in range(4)],
                    "skinned")
    assert not torch.equal(outs[0]["image"], outs[2]["image"])


def test_swapped_scene_of_the_same_shapes(scene):
    eager, program = pair(scene)
    lockstep(eager, program, [dict(camera=cam(0), scene=moved(scene, k)) for k in range(4)],
             "swapped scene")
    assert len(program.programs) == 1


def test_checkpoint_round_trip(scene, tmp_path):
    eager, program = pair(scene, dataclasses.replace(CFG, **DYNAMIC), shadows=True)
    lockstep(eager, program, [dict(camera=cam(k)) for k in range(2)], "before the checkpoint")
    for name, r in (("eager", eager), ("program", program)):
        save_renderer(str(tmp_path / name), r)
    lockstep(eager, program, [dict(camera=cam(2))], "after the checkpoint")
    buffers = [id(v) for v in tree.leaves(program._state)]
    for name, r in (("eager", eager), ("program", program)):
        load_renderer(str(tmp_path / name), r)
    assert [id(v) for v in tree.leaves(program._state)] == buffers  # copied into them
    lockstep(eager, program, [dict(camera=cam(k)) for k in (2, 3)], "restored")


def test_reload_drops_the_programs(scene, tmp_path):
    module = tmp_path / "program_reload_probe.py"
    module.write_text("X = 0\n")
    sys.path.insert(0, str(tmp_path))
    try:
        __import__("program_reload_probe")
        eager, program = pair(scene)
        reloader = KernelReloader(program, rebuild=lambda: build_forward_plan,
                                  modules=["program_reload_probe"], sources=[])
        lockstep(eager, program, [dict(camera=cam(0))], "before the reload")
        assert len(program.programs) == 1
        time.sleep(0.01)
        module.write_text("X = 1\n")
        os.utime(module)
        assert reloader.poll() is True
        assert program.programs == {} and program._plans == {}
        lockstep(eager, program, [dict(camera=cam(k)) for k in (1, 2)], "after the reload")
    finally:
        sys.path.remove(str(tmp_path))
        sys.modules.pop("program_reload_probe", None)


def test_cond_eager_is_where():
    rng = np.random.default_rng(3)
    prev = torch.from_numpy(rng.standard_normal((8, 8)).astype(np.float32))
    fresh = torch.from_numpy(rng.standard_normal((8, 8)).astype(np.float32))
    calls = []

    def body():
        calls.append(1)
        return fresh

    for p in (True, False):
        got = control.cond(torch.tensor(p), body, prev)
        assert torch.equal(got, torch.where(torch.tensor(p), fresh, prev))
    assert len(calls) == 2  # eagerly the body always runs


# -- on the card -------------------------------------------------------------

# name -> (config changes, switches, scene frames move the mover)
CARD_TIERS = {
    "base_exact": ({}, {}, False),
    "base_checkerboard_fix": (dict(shade_rate="checkerboard"), {}, False),
    "quarter_fix": (dict(shade_rate="quarter"), {}, False),
    "ssaa2": (dict(ssaa=2, aa="none"), {}, False),
    "lambert": (dict(shading="lambert", aa="none"), {}, False),
    "skinned": (dict(skinning=True), {}, False),
    "rt_scale1": (dict(rt_scale=1), dict(rt=True), False),
    "rt_scale2": ({}, dict(rt=True), False),
    "rt_scale4": (dict(rt_scale=4), dict(rt=True), False),
    "shadowed_static_exact": ({}, dict(shadows=True), False),
    "shadowed_static_checkerboard_fix": (dict(shade_rate="checkerboard"), dict(shadows=True),
                                         False),
    "shadowed_dynamic": (dict(shade_rate="checkerboard", shadow_update_budget=1,
                              shadow_progressive=4), dict(shadows=True), True),
    "freeze": ({}, dict(freeze_culling=True), False),
    "debug_aabbs": ({}, dict(debug_aabbs=True), False),
    "occlusion": ({}, dict(occlusion_culling=True), False),
    "cluster_cull": (dict(cluster_cull=True), {}, False),
    "reference_image": ({}, dict(reference_image=True), False),
    "hud": ({}, dict(hud=True), False),
    "plain": (dict(tile_raster=False), {}, False),
    "plain_rt": (dict(tile_raster=False), dict(rt=True), False),
    "plain_shadowed": (dict(tile_raster=False), dict(shadows=True), True),
}
CARD_CFG = PipelineConfig(width=256, height=128, tri_capacity=8192, aa="edge", trilinear=False,
                          shadow_size=256)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _card_frames(name, frames=4):
    """The tier's frames through an eager and a replayed Renderer, in
    lockstep; both see the switches from their second frame on."""
    from renderer_tpu_torch.ops.overlay import hud_overlay

    dev = _card()
    changes, switches, move = CARD_TIERS[name]
    scene = sponza_like_scene(256, device=dev)
    cfg = dataclasses.replace(CARD_CFG, **changes)
    eager = Renderer(scene, cfg, replay=False)
    program = Renderer(scene, cfg)
    assert program.replay and not eager.replay
    aspect = cfg.width / cfg.height
    for k in range(frames):
        if k == 1:
            for r in (eager, program):
                r.set_config(**switches)
                r.apply_config_now()
        kw = dict(camera=orbit_camera(0.3 + 0.01 * k, aspect, dev), time_s=k / 30.0,
                  scene=moved(scene, k) if move else None,
                  overlay=hud_overlay(f"frame {k}", cfg.width) if "hud" in switches else None)
        a, b = eager.render(**kw), program.render(**kw)
        torch.cuda.synchronize()
        assert_same(a, b, f"{name}: frame {k} outputs")
        assert_same(eager.state, program.state, f"{name}: frame {k} state")
    return program


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(CARD_TIERS))
def test_replay_equals_eager(name):
    program = _card_frames(name)
    assert program.stats["compiles"] == (2 if CARD_TIERS[name][1] else 1)  # per switch set
    assert all(p.graphs for p in program.programs.values())


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["shadowed_static_checkerboard_fix", "shadowed_dynamic"])
def test_shadowed_replay_through_conditional_nodes_equals_eager(name):
    """The shadowed frames replayed through the atlas's conditional nodes
    equal the eager frames (``torch.where``) bit for bit (``_card_frames``'
    lockstep), and the shadowed program made the nodes."""
    _card()
    ok, why = control.conditional_nodes()
    if not ok:
        pytest.skip(f"no conditional nodes: {why}")
    program = _card_frames(name)
    shadowed = next(p for key, p in program.programs.items()
                    if dict(key[0]) == vars(program.config))
    assert shadowed.conditional is None and any(c.bodies for c in shadowed._bodies)


@pytest.mark.gpu
def test_launches_count_replays():
    dev = _card()
    r = Renderer(sponza_like_scene(256, device=dev), CARD_CFG)
    aspect = CARD_CFG.width / CARD_CFG.height
    kernel = raster_cuda.RASTER_TILES
    kernel.launches = 0
    for k in range(5):
        r.render(orbit_camera(0.3 + 0.01 * k, aspect, dev))
    assert kernel.launches == 5 and r.stats["compiles"] == 1


@pytest.mark.gpu
def test_conditional_node_skips_an_unselected_slot():
    """A static shadowed scene: the atlas's slot renders on the first
    replayed frame after the state is reset (every unit dirty) and on no
    later one; an unselected slot launches no kernel and leaves the atlas
    as it was; a moved caster selects it again."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev = _card()
    ok, why = control.conditional_nodes()
    if not ok:
        pytest.skip(f"no conditional nodes: {why}")
    scene = sponza_like_scene(256, device=dev)
    r = Renderer(scene, CARD_CFG)
    r.set_config(shadows=True)
    r.apply_config_now()
    aspect = CARD_CFG.width / CARD_CFG.height
    fresh_state = {k: tree.unflatten(tree.flatten(v)[1], [t.clone() for t in tree.leaves(v)])
                   for k, v in r.state.items()}
    r.render(orbit_camera(0.3, aspect, dev))  # warm-up and capture
    kernel = raster_cuda.RASTER_TILES

    def frame(k, s=None):
        kernel.launches = 0
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            r.render(orbit_camera(0.3 + 0.01 * k, aspect, dev), scene=s)
            torch.cuda.synchronize()
        walks = sum(e.count for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA and "raster_walk" in e.key)
        return kernel.launches, walks

    r.state = fresh_state  # every unit dirty again
    assert frame(1) == (2, 2)  # the camera's raster and the slot's
    atlas = r.state["shadow_cache"][0].clone()
    assert frame(2) == (1, 1)  # the slot unselected: its body did not run
    assert torch.equal(r.state["shadow_cache"][0], atlas)
    assert frame(3, moved(scene, 4)) == (2, 2)
    assert not torch.equal(r.state["shadow_cache"][0], atlas)
