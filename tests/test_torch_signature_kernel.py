"""Kernel 8, the cached atlas's change-detection signatures
(``ops/shadow.shadow_signature_kernel``, ``csrc/signature.cu``), against
its plain version ``shadow_signature`` (held to the JAX package by
``tests/test_torch_shadow.py``). Free of jax:

    python -m pytest tests/test_torch_signature_kernel.py -m gpu -q

Gates. On the card, bit for bit: each unit's visible instances (read out
of the signatures through weights that spell each instance as a bit)
equal ``coarse_cull``'s through ``signature_visibility`` over every band
frustum, for a mixed slot pattern (directional slots of 16 bands and of 1,
a point slot, an empty slot, some instances not alive), for the
envelope's 16 lights and for 70 slots of 40 bands (more slots than one
launch's table holds, more bands than one chunk of planes); the sentinels equal the plain version's; two calls
and 20 replays of a captured CUDA graph give the same bits, and a replay on
new inputs equals an eager call on them. The fold sums in its own order,
so values are not compared with the plain version's: the dirty units are,
frame by frame, over a scripted sequence (static, a nudge, a jump, a moved
light, instances no longer alive), and the cached atlas's written units,
cursor and atlas equal the plain path's over 40 frames of a moving caster
and an orbiting light. On the CPU: the batched planes equal the per-slot
``band_matrix`` + ``frustum_planes`` bit for bit, the unit table of each
slot kind, a CPU cached atlas neither builds nor loads the kernel, and
another device raises.
"""

import math

import pytest
import torch

from renderer_tpu_torch.mathx import orbit_camera
from renderer_tpu_torch.mathx.camera import frustum_planes
from renderer_tpu_torch.models import shadow_envelope_lights, sponza_like_scene
from renderer_tpu_torch.ops import geometry
from renderer_tpu_torch.ops import shadow as tshadow
from renderer_tpu_torch.ops.rt_grid import slot_lights
from renderer_tpu_torch.ops.shadow import (SIG_C, SIGNATURE, SignatureSlot, SignatureWeights,
                                           band_matrix, shadow_signature,
                                           shadow_signature_kernel, signature_planes,
                                           signature_units, signature_visibility)
from renderer_tpu_torch.runtime.frame import light_casts
from renderer_tpu_torch.scene import SceneBuilder, SceneLimits, primitives

CPU = torch.device("cpu")
N_SLOTS = 4
MIXED_BOXES = 700  # a ragged last tile of 256


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def mixed_scene(device):
    """A floor and a field of boxes; a directional light in slot 0, a point
    light in slot 1, slot 2 empty, a directional light in slot 3."""
    b = SceneBuilder(SceneLimits(max_instances=1024, max_vertices=4096, max_triangles=4096,
                                 max_meshes=16, max_materials=16, max_lights=4,
                                 max_textures=4), atlas_size=16)
    plane = b.add_mesh(primitives.plane(size=30.0))
    box = b.add_mesh(primitives.box())
    grey = b.add_material(base_color=(0.8, 0.8, 0.8, 1), roughness=1.0)
    b.add_instance(plane, grey)
    for i in range(MIXED_BOXES):
        x, z = (i % 27) - 13.0, (i // 27) - 13.0
        b.add_instance(box, grey, translation=(x, 0.3 + 0.1 * (i % 5), z),
                       scale=0.2 + 0.05 * (i % 7))
    b.add_light(position=(1.0, -1.0, 0.3), directional=True, intensity=3.0, shadow_slot=0)
    b.add_light(position=(1.5, 4.0, 0.5), intensity=40.0, shadow_slot=1)
    b.add_light(position=(-0.4, -1.0, -0.7), directional=True, intensity=2.0, shadow_slot=3)
    return b.build(device=device)


def envelope_scene(device):
    """The benchmark envelope's light table on a small bench scene."""
    scene = sponza_like_scene(2000, seed=3, limits=SceneLimits(
        max_instances=2048, max_vertices=65536, max_triangles=65536, max_materials=64,
        max_lights=16), device=device)
    return scene._replace(lights=shadow_envelope_lights(16, device=device))


# name -> (scene, atlas slots, live slots); "wide": more slots than a launch's table holds
SCENES = {"mixed": (mixed_scene, N_SLOTS, 3), "envelope": (envelope_scene, 16, 16),
          "wide": (mixed_scene, 70, 3)}
WIDE_BANDS = 40  # more bands than shared memory holds at a time (32), a ragged last chunk


class Inputs:
    """A scene, its light matrices and model rows at a camera, its slots."""

    def __init__(self, scene, n_slots, angle=0.3):
        self.scene = scene
        dev = scene.instances.alive.device
        prep = geometry.prepare_frame_columns(scene, orbit_camera(angle, 16 / 9, device=dev))
        self.model = prep.model
        self.mats = tshadow.light_matrices_cube(scene.lights, prep.scene_min, prep.scene_max)
        self.slots = slot_lights(light_casts(scene.lights, scene.lights.alive.shape[0]), n_slots)

    def signature(self, k, kernel=True, weights=None):
        fn = shadow_signature_kernel if kernel else shadow_signature
        return fn(self.scene, self.mats, self.model, self.slots, k, weights)


def inputs(name, device, dead=()):
    make, n_slots, _ = SCENES[name]
    scene = make(device)
    if dead:
        alive = scene.instances.alive.clone()
        alive[list(dead)] = False
        scene = scene._replace(instances=scene.instances._replace(alive=alive))
    return Inputs(scene, n_slots)


def with_moves(scene, k):
    """Frame k of the moving caster (instance 1) and the orbiting light 0."""
    inst, lights = scene.instances, scene.lights
    t = inst.translation.clone()
    t[1] = torch.tensor([2.5 * math.sin(0.3 * k), 0.6, 2.5 * math.cos(0.21 * k)])
    pos = lights.position.clone()
    d = torch.tensor([0.6 * math.sin(0.25 * k), -1.0, 0.6 * math.cos(0.25 * k)])
    pos[0] = d / torch.linalg.norm(d)
    return scene._replace(instances=inst._replace(translation=t),
                          lights=lights._replace(position=pos))


# --- on the card ---------------------------------------------------------------------

def spelled_visibility(inp, k):
    """(n_slots, units, N) bool read out of kernel 8 (``chip_smoke``'s
    reading: every weight 0 but the count term, which spells each instance
    as a bit)."""
    import chip_smoke

    n, dev = inp.model.shape[0], inp.model.device
    return chip_smoke.spelled_visibility(lambda w: inp.signature(k, weights=w), inp.slots, k, n,
                                         dev)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 16, WIDE_BANDS])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_kernel_visibility_equals_coarse_cull(name, k, cuda_device):
    inp = inputs(name, cuda_device, dead=(3, 4, 300, 699))
    before = SIGNATURE.launches
    got = spelled_visibility(inp, k)
    assert SIGNATURE.launches > before
    n_live = 0
    for slot, e in enumerate(signature_units(inp.slots, k)):
        if e.light < 0:
            continue
        want = signature_visibility(inp.scene, inp.model, inp.mats, inp.slots[slot], k)
        assert torch.equal(got[slot, :e.units], want), (slot, (got[slot, :e.units] != want).sum())
        assert not got[slot, e.units:].any()
        n_live += 1
        seen = want.any(dim=0).float().mean().item()
        assert 0.05 < seen and not want[:, inp.scene.instances.alive.logical_not()].any()
    assert n_live == SCENES[name][2]


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 16, WIDE_BANDS])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_kernel_sentinels_and_launches(name, k, cuda_device):
    inp = inputs(name, cuda_device)
    before = SIGNATURE.launches
    got = inp.signature(k)
    want = inp.signature(k, kernel=False)
    torch.cuda.synchronize()
    assert SIGNATURE.launches == before + 1 and got.shape == want.shape
    fixed = torch.tensor([e.light < 0 for e in signature_units(inp.slots, k)], device=cuda_device)
    g, w = got.reshape(len(inp.slots), -1, SIG_C), want.reshape(len(inp.slots), -1, SIG_C)
    assert torch.equal(g[fixed], w[fixed])  # the empty slots' sentinels
    for slot, e in enumerate(signature_units(inp.slots, k)):
        assert torch.equal(g[slot, e.units:], w[slot, e.units:])  # the untracked units'
        assert torch.isfinite(g[slot]).all()


@pytest.mark.gpu
def test_kernel_is_deterministic_in_a_graph(cuda_device):
    inp = inputs("envelope", cuda_device)
    weights = tshadow.signature_weights(inp.model.shape[0], cuda_device)
    model = inp.model.clone()
    first = shadow_signature_kernel(inp.scene, inp.mats, model, inp.slots, 16, weights)
    assert torch.equal(first, shadow_signature_kernel(inp.scene, inp.mats, model, inp.slots, 16,
                                                      weights))
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = shadow_signature_kernel(inp.scene, inp.mats, model, inp.slots, 16, weights)
    for _ in range(20):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, first)
    moved = Inputs(with_moves(inp.scene, 7), 16, angle=0.5)
    model.copy_(moved.model)
    graph.replay()
    want = shadow_signature_kernel(inp.scene, inp.mats, moved.model, inp.slots, 16, weights)
    torch.cuda.synchronize()
    assert torch.equal(out, want) and not torch.equal(out, first)


def sequence(base):
    """Static, a nudged caster, a jump, a moved light, instances not alive."""
    inst, lights = base.instances, base.lights

    def at(box=None, light=None, dead=()):
        t, pos, alive = inst.translation.clone(), lights.position.clone(), inst.alive.clone()
        if box is not None:
            t[1] = torch.tensor(box)
        if light is not None:
            pos[0] = torch.tensor(light)
        alive[list(dead)] = False
        return base._replace(instances=inst._replace(translation=t, alive=alive),
                             lights=lights._replace(position=pos))

    jump, light = (-2.5, 0.8, 2.0), (0.2, -1.0, 0.8)
    return [base, base, at((-12.95, 0.3, -13.0)), at(jump), at(jump, light),
            at(jump, light, dead=range(40, 60)), at(jump, light, dead=range(40, 60))]


@pytest.mark.gpu
@pytest.mark.parametrize("k,n_slots", [(1, N_SLOTS), (4, N_SLOTS), (16, N_SLOTS),
                                       (WIDE_BANDS, SCENES["wide"][1])])
def test_kernel_dirties_the_same_units(k, n_slots, cuda_device):
    base = mixed_scene(cuda_device)
    prev = None
    dirty_seen = []
    for scene in sequence(base):
        inp = Inputs(scene, n_slots)
        sig = (inp.signature(k), inp.signature(k, kernel=False))
        if prev is not None:
            got, want = ((s != p).reshape(n_slots, -1, SIG_C).any(dim=-1)
                         for s, p in zip(sig, prev))
            assert torch.equal(got, want), (got, want)
            dirty_seen.append(int(want.sum()))
        prev = sig
    assert dirty_seen[0] == 0 and dirty_seen[-1] == 0 and all(d > 0 for d in dirty_seen[1:-1])


@pytest.mark.gpu
@pytest.mark.parametrize("k,budget", [(16, 1), (1, 2)])
def test_cached_atlas_matches_the_plain_path(k, budget, cuda_device, monkeypatch):
    """40 frames of a moving caster and an orbiting light: the units each
    frame writes, the cursor and the atlas, kernel 8 against the plain
    signatures."""
    size, cap = 256, 4096
    base = mixed_scene(cuda_device)
    states = {True: tshadow.initial_cache(N_SLOTS, size, k, cuda_device),
              False: tshadow.initial_cache(N_SLOTS, size, k, cuda_device)}
    plain_launches = SIGNATURE.launches
    written = []
    for frame in range(40):
        inp = Inputs(with_moves(base, frame), N_SLOTS, angle=0.3 + 0.01 * frame)
        new = {}
        for kernel in (True, False):
            if not kernel:
                monkeypatch.setattr(tshadow, "signatures", shadow_signature)
                plain_launches = SIGNATURE.launches
            prep_lod = torch.zeros_like(inp.scene.instances.mesh_id, dtype=torch.int64)
            _, new[kernel] = tshadow.render_shadow_atlas_cached(
                inp.scene, inp.mats, inp.model, prep_lod, inp.slots, size, cap, states[kernel],
                budget=budget, progressive=k)
            if not kernel:
                monkeypatch.undo()
                assert SIGNATURE.launches == plain_launches

        def units(state, old):
            return ~((state[1] == old[1]) | (torch.isnan(state[1]) & torch.isnan(old[1]))).all(-1)

        got, want = units(new[True], states[True]), units(new[False], states[False])
        assert torch.equal(got, want), (frame, got, want)
        assert int(new[True][2]) == int(new[False][2])
        assert torch.equal(new[True][0], new[False][0]), frame
        written.append(int(want.sum()))
        states = new
    assert all(0 < w <= budget for w in written), written


# --- on the CPU --------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 4, 16, WIDE_BANDS])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_signature_planes_equal_the_per_slot_planes(name, k):
    inp = inputs(name, CPU)
    table = signature_units(inp.slots, k)
    planes = signature_planes(inp.mats, table)
    assert planes.shape == (sum(e.units * e.views for e in table), 6, 4)
    for e in table:
        if e.light < 0:
            continue
        mats = inp.mats[e.light]
        if e.views == 6:
            want = frustum_planes(mats)
        elif k > 1:
            want = frustum_planes(band_matrix(mats[0], torch.arange(k), k))
        else:
            want = frustum_planes(mats[0])[None]
        assert torch.equal(planes[e.view0:e.view0 + e.units * e.views], want), e


UNIT_TABLES = {  # (slots, progressive) -> the unit table
    "directional_bands": (((0, True), (5, True)), 16,
                          (SignatureSlot(0, 16, 1, 0, 17.0), SignatureSlot(5, 16, 1, 16, 17.0))),
    "directional_whole": (((2, True),), 1, (SignatureSlot(2, 1, 1, 0, 17.0),)),
    "point": (((1, False), (3, True)), 4,
              (SignatureSlot(1, 1, 6, 0, 39.0), SignatureSlot(3, 4, 1, 6, 17.0))),
    "empty": ((None, (0, True), None), 2,
              (SignatureSlot(-1, 0, 0, 0, 0.0), SignatureSlot(0, 2, 1, 0, 17.0),
               SignatureSlot(-1, 0, 0, 0, 0.0))),
}


@pytest.mark.parametrize("case", sorted(UNIT_TABLES))
def test_signature_units_of_each_slot_kind(case):
    slots, k, want = UNIT_TABLES[case]
    assert signature_units(slots, k) == want


def test_cpu_cached_atlas_builds_no_kernel(monkeypatch):
    def refuse(*_):
        raise AssertionError("csrc/signature.cu built or loaded for a CPU frame")

    monkeypatch.setattr(tshadow.LIBRARY, "start", refuse)
    monkeypatch.setattr(tshadow.LIBRARY, "load", refuse)
    inp = inputs("mixed", CPU)
    before = SIGNATURE.launches
    sig = tshadow.signatures(inp.scene, inp.mats, inp.model, inp.slots, 4)
    assert torch.equal(sig, inp.signature(4, kernel=False))
    state = tshadow.initial_cache(N_SLOTS, 128, 4, CPU)
    lod = torch.zeros_like(inp.scene.instances.mesh_id, dtype=torch.int64)
    _, state = tshadow.render_shadow_atlas_cached(inp.scene, inp.mats, inp.model, lod, inp.slots,
                                                  128, 1024, state, budget=1, progressive=4)
    assert torch.equal(state[1][0, 0], sig[0, 0]) and SIGNATURE.launches == before
    with pytest.raises(ValueError, match="CUDA"):  # the kernel's wrapper takes no CPU tensor
        inp.signature(4)


def test_another_device_raises():
    inp = inputs("mixed", CPU)
    meta = torch.empty(inp.model.shape, device="meta")
    with pytest.raises(ValueError, match="no shadow signature kernel for device meta"):
        tshadow.signatures(inp.scene, inp.mats, meta, inp.slots, 4)
