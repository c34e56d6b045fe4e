"""The port's 16-slot band schedule on its own, at the envelope test's size
(``test_torch_envelope.py``): 16 directional slots of 128x128 in 2 bands,
the cache at budget 1, two shaded lights; and the card's configuration
(16 slots of 4096x4096 in 16 bands of 4096x256) accepted as it stands.

- Budget 1 renders exactly one unit a frame until all 16 x K have
  rendered, then none; every slot then holds depth, shaded or not.
- Light 7 moved: the next K frames render exactly its slot's K bands.
- Light 7 moving every frame: at most one band a frame, all of slot 7.
- The atlas's slot pattern is part of the Renderer's light contract.
"""

import math

import numpy as np
import pytest
import torch

from renderer_tpu_torch.mathx import Camera
from renderer_tpu_torch.models import shadow_envelope_lights, sponza_like_scene
from renderer_tpu_torch.ops.rt_grid import slot_lights
from renderer_tpu_torch.passes.pipeline import PipelineConfig, build_forward_plan
from renderer_tpu_torch.runtime import Renderer
from renderer_tpu_torch.runtime.frame import light_casts
from renderer_tpu_torch.scene import SceneLimits

N_LIGHTS = 16
K = 2  # bands per slot
UNITS = N_LIGHTS * K
W, H = 256, 64
LIMITS = dict(max_instances=16384, max_vertices=1 << 16, max_triangles=1 << 16,
              max_materials=64, max_lights=N_LIGHTS)
OPTS = dict(width=W, height=H, tri_capacity=4096, aa="edge", enable_normal_maps=True,
            trilinear=False, shade_rate="checkerboard", shade_fix=True, shadow_slots=N_LIGHTS,
            shadow_size=128, shadow_update_budget=1, shadow_progressive=K, shade_light_slots=2)
MOVED = (0.1, -1.0, 0.6)  # light 7's new direction (scripts/prof_shadow_amort.py:112)
POS, PITCH = [6.0, 12.0, 14.0], -0.7
CAM = dict(rotation=[math.cos(PITCH / 2), math.sin(PITCH / 2), 0.0, 0.0], fov_y=0.9, near=0.1,
           far=60.0, aspect=W / H)
# the card's configuration (chip_smoke.py's envelope phase)
CARD = dict(width=1920, height=1088, tri_capacity=131072, aa="edge", enable_normal_maps=True,
            trilinear=False, shade_rate="checkerboard", shade_fix=True, shadow_slots=16,
            shadow_size=4096, shadow_cache=True, shadow_update_budget=1, shadow_progressive=16,
            shade_light_slots=2, shadow_tri_capacity=0)


def port_scene():
    scene = sponza_like_scene(64, limits=SceneLimits(**LIMITS), device="cpu")
    return scene._replace(lights=shadow_envelope_lights(N_LIGHTS, device="cpu"))


def with_light7(scene, direction):
    """The scene with light 7 pointing along ``direction``."""
    pos = scene.lights.position.clone()
    pos[7] = torch.tensor(direction, dtype=torch.float32)
    return scene._replace(lights=scene.lights._replace(position=pos))


def port_renderer():
    r = Renderer(port_scene(), PipelineConfig(**OPTS), outputs=("image",))
    r.set_config(shadows=True)
    r.apply_config_now()
    return r


def port_camera():
    return Camera.create(POS, **CAM, device="cpu")


def rendered_units(sig, sig_prev) -> np.ndarray:
    """(slots, K) bool: the units whose signature the frame wrote (a NaN
    signature left NaN is unchanged)."""
    sig, sig_prev = np.asarray(sig), np.asarray(sig_prev)
    same = (sig == sig_prev) | (np.isnan(sig) & np.isnan(sig_prev))
    return ~same.all(axis=-1)


def run(r, frames, scene_at=lambda k: None) -> list:
    """Frames 1..frames; per frame the (slots, K) units rendered."""
    cam = port_camera()
    out = []
    for k in range(1, frames + 1):
        before = r.state["shadow_cache"][1].clone()
        r.render(cam, scene=scene_at(k))
        out.append(rendered_units(r.state["shadow_cache"][1], before))
    return out


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module: its frames are thousands of
    small ops, which PyTorch's thread pool slows several times over when
    the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def converged():
    """A renderer run to convergence: (units per frame, its state)."""
    r = port_renderer()
    units = run(r, UNITS + 2)
    return units, {k: v for k, v in r.state.items()}


def converged_renderer(state):
    r = port_renderer()
    r.state = {k: (tuple(t.clone() for t in v) if k == "shadow_cache" else v)
               for k, v in state.items()}
    return r


def test_budget_one_renders_one_unit_a_frame_until_converged(converged):
    units, state = converged
    per_frame = [int(u.sum()) for u in units]
    assert per_frame == [1] * UNITS + [0, 0], per_frame
    assert np.logical_or.reduce(units[:UNITS]).all(), "a unit never rendered"
    assert not torch.isnan(state["shadow_cache"][1]).any()
    atlas = state["shadow_cache"][0]
    assert ((atlas < 1.0).float().mean(dim=(1, 2)) > 0.05).all(), "a slot holds no depth"


def test_moved_light_dirties_only_its_slots_bands(converged):
    r = converged_renderer(converged[1])
    moved = with_light7(r.scene, MOVED)
    units = run(r, K + 1, lambda k: moved)
    assert [int(u.sum()) for u in units] == [1] * K + [0]
    done = np.logical_or.reduce(units)
    assert done[7].all() and not np.delete(done, 7, axis=0).any()


def test_orbiting_light_renders_at_most_one_band_a_frame(converged):
    r = converged_renderer(converged[1])
    base = r.scene

    def orbit(k):  # scripts/prof_shadow_amort.py:136-144
        a = 0.25 * k
        d = np.asarray([0.6 * math.sin(a), -1.0, 0.6 * math.cos(a)], np.float32)
        return with_light7(base, tuple(d / np.linalg.norm(d)))

    units = run(r, 2 * K + 1, orbit)
    assert all(int(u.sum()) == 1 and u[7].any() for u in units), [np.argwhere(u) for u in units]


def test_atlas_pattern_is_part_of_the_light_contract():
    r = port_renderer()
    assert slot_lights(r.atlas_casts, N_LIGHTS) == tuple((i, True) for i in range(N_LIGHTS))
    assert r.light_casts == ((0, True), (1, True))
    lights = r.scene.lights
    dead = lights._replace(alive=torch.where(torch.arange(N_LIGHTS) == 9, False, lights.alive))
    with pytest.raises(ValueError, match="light cast pattern"):
        r.render(port_camera(), scene=r.scene._replace(lights=dead))


def test_card_configuration_is_accepted():
    cfg = PipelineConfig(**CARD)
    assert cfg.caster_capacity == 131072 and cfg.shadow_size // cfg.shadow_progressive == 256
    table = shadow_envelope_lights(N_LIGHTS, device="cpu")
    casts = light_casts(table, N_LIGHTS)
    names = [p.name for p in build_forward_plan(cfg, ("image",), casts[:2], shadows=True,
                                                atlas_casts=casts)]
    assert "shadow_pass" in names and "shade_shadowed" in names
    with pytest.raises(ValueError, match="shadow_progressive"):
        PipelineConfig(**{**CARD, "shadow_update_budget": 0})
