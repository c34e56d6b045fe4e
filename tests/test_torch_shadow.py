"""The port's shadow-map modules (light cameras, change detection and
scheduling, the per-light and cached atlas, the PCF lookup) against the JAX
package's, at tiny sizes: 128x128 slots, 1024 casters, one directional
and one point light.

Gates, with their reasons:
- light matrices and band matrices within rtol = atol = 1e-6 (float32
  products summed in other orders);
- scheduling: selection, signatures and cursor equal (the four cases of
  tests/test_shadow_cache.py);
- signatures: the same units dirty frame by frame in a scripted sequence
  (values are sums in other orders, so they are not compared);
- atlas depth within 1e-5 on >= 99.9% of texels: the JAX package renders a
  slot with its Pallas kernel (interpret mode) and a cube face with its XLA
  rasterizer, so triangle setup rounds differently at a few edge texels;
- lookup within 1e-6 on >= 99.99% of receivers (same atlas and inputs).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from renderer_tpu.mathx import camera as jcam
from renderer_tpu.ops import geometry as jgeo
from renderer_tpu.ops import shadow as jshadow
from renderer_tpu.scene import SceneBuilder as JaxBuilder, SceneLimits as JaxLimits, primitives
from renderer_tpu.scene.types import as_numpy_scene
from renderer_tpu_torch.mathx import Camera
from renderer_tpu_torch.ops import geometry as tgeo
from renderer_tpu_torch.ops import shadow as tshadow
from renderer_tpu_torch.ops.rt_grid import slot_lights
from renderer_tpu_torch.runtime.frame import light_casts
from renderer_tpu_torch.scene import scene_from_numpy

CPU = "cpu"
S, CAP, N_SLOTS = 128, 1024, 4
TOL6 = dict(rtol=1e-6, atol=1e-6)


def t(a):
    return torch.from_numpy(np.array(a))


def mixed_scene():
    """A floor, a box and a small box; a directional light in slot 0 and a
    point light in slot 1 (the light table's order is the slot order)."""
    b = JaxBuilder(JaxLimits.tiny(), atlas_size=16)
    plane = b.add_mesh(primitives.plane(size=10.0))
    box = b.add_mesh(primitives.box())
    grey = b.add_material(base_color=(0.8, 0.8, 0.8, 1), roughness=1.0)
    red = b.add_material(base_color=(0.8, 0.2, 0.2, 1), roughness=0.8)
    b.add_instance(plane, grey)
    b.add_instance(box, red, translation=(0.0, 0.8, 0.0))
    b.add_instance(box, red, translation=(2.5, 0.4, -1.5), scale=0.5)
    b.add_light(position=(1.0, -1.0, 0.3), directional=True, intensity=3.0, shadow_slot=0)
    b.add_light(position=(1.5, 4.0, 0.5), intensity=40.0, shadow_slot=1)
    return b.build()


CAM = dict(position=[0.0, 6.0, 0.01], fov_y=1.1, near=0.1, far=50.0, aspect=1.0,
           rotation=[math.cos(-math.pi / 4), math.sin(-math.pi / 4), 0.0, 0.0])


class Frame:
    """One scene state on both sides: the JAX scene and prepare, the port's."""

    def __init__(self, jscene):
        self.jscene = jscene
        self.tscene = scene_from_numpy(as_numpy_scene(jscene), device=CPU)
        self.jprep = jgeo.prepare_frame_columns(
            jscene, jcam.Camera.create(**{k: jnp.asarray(v) for k, v in CAM.items()}))
        self.tprep = tgeo.prepare_frame_columns(self.tscene, Camera.create(**CAM, device=CPU))
        self.jmats = jshadow.light_matrices_cube(jscene.lights, self.jprep[5], self.jprep[6])
        self.tmats = tshadow.light_matrices_cube(self.tscene.lights, self.tprep.scene_min,
                                                 self.tprep.scene_max)
        self.slots = slot_lights(light_casts(self.tscene.lights, 2), N_SLOTS)


def moved(jscene, box=None, light=None):
    """The scene with instance 1 at ``box`` and light 0 pointing along ``light``."""
    inst, lights = jscene.instances, jscene.lights
    if box is not None:
        inst = inst._replace(translation=inst.translation.at[1].set(jnp.asarray(box)))
    if light is not None:
        lights = lights._replace(position=lights.position.at[0].set(jnp.asarray(light)))
    return jscene._replace(instances=inst, lights=lights)


_FRAME = {}


def base_frame():
    if "base" not in _FRAME:
        _FRAME["base"] = Frame(mixed_scene())
    return _FRAME["base"]


def jax_atlas(f):
    if not hasattr(f, "jatlas"):
        f.jatlas = np.asarray(jshadow.render_shadow_atlas_per_light(
            f.jscene, f.jmats, f.jscene.lights, f.jprep[0], f.jprep[4], N_SLOTS, S, CAP,
            use_pallas=True, pallas_interpret=True, scene_min=f.jprep[5], scene_max=f.jprep[6]))
    return f.jatlas


def port_atlas(f, **kw):
    return tshadow.render_shadow_atlas_per_light(
        f.tscene, f.tmats, f.tprep.model, f.tprep.lod, f.slots, S, CAP,
        scene_min=f.tprep.scene_min, scene_max=f.tprep.scene_max, **kw)


def assert_depth_close(got, want, what):
    close = np.abs(got - want) <= 1e-5
    assert close.mean() >= 0.999, f"{what}: {(~close).sum()} texels differ"


# --- light cameras ------------------------------------------------------------

def test_light_matrices_cube_and_band_matrix_match_jax():
    rng = np.random.default_rng(0)
    f = base_frame()
    for trial in range(2):
        n = 8
        pos = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
        pos[0] = (0.01, -1.0, 0.02)  # nearly vertical: the other up axis
        directional = rng.random(n) < 0.5
        alive = rng.random(n) < 0.8
        slot = np.where(rng.random(n) < 0.8, np.arange(n), -1).astype(np.int32)
        smin = rng.uniform(-8, -1, 3).astype(np.float32)
        smax = smin + rng.uniform(0.5, 10, 3).astype(np.float32)
        jl = f.jscene.lights._replace(position=jnp.asarray(pos), directional=jnp.asarray(directional),
                                      alive=jnp.asarray(alive), shadow_slot=jnp.asarray(slot))
        tl = f.tscene.lights._replace(position=t(pos), directional=t(directional), alive=t(alive),
                                      shadow_slot=t(slot))
        want = np.asarray(jshadow.light_matrices_cube(jl, jnp.asarray(smin), jnp.asarray(smax)))
        got = tshadow.light_matrices_cube(tl, t(smin), t(smax))
        assert got.shape == want.shape == (n, 6, 4, 4)
        np.testing.assert_allclose(got.numpy(), want, **TOL6)
        for band in range(4):
            m = want[trial, 1]
            np.testing.assert_allclose(
                tshadow.band_matrix(t(m), torch.tensor(band), 4).numpy(),
                np.asarray(jshadow.band_matrix(jnp.asarray(m), band, 4)), **TOL6)
    assert tshadow.shadow_lod_bias(512) == jshadow.shadow_lod_bias(512) == 3.0


# --- scheduling ----------------------------------------------------------------

SELECT_CASES = {  # name -> (sig, prev, cursor, budget, frames)
    "no_budget": ([1.0, 2.0, 3.0, 4.0], [1.0, 9.0, math.nan, 4.0], 0, 0, 1),
    "round_robin": ([1.0, 2.0, 3.0, 4.0], [math.nan] * 4, 0, 1, 5),
    "resumes_past_cursor": ([1.0, 2.0, 3.0, 4.0], [1.0, 99.0, 3.0, 99.0], 2, 1, 2),
    "multicomponent": ([[1.0, 5.0], [2.0, 6.0], [3.0, 7.0]],
                       [[1.0, 5.0], [2.0, 9.0], [math.nan, math.nan]], 0, 0, 1),
}


@pytest.mark.parametrize("name", sorted(SELECT_CASES))
def test_select_shadow_updates_matches_jax(name):
    sig, prev, cursor, budget, frames = SELECT_CASES[name]
    sig = np.float32(sig)
    jprev, jcur = jnp.asarray(np.float32(prev)), jnp.int32(cursor)
    tprev, tcur = t(np.float32(prev)), torch.tensor(cursor, dtype=torch.int32)
    for _ in range(frames):  # each frame starts from the last frame's state
        jsel, jprev, jcur = jshadow.select_shadow_updates(jnp.asarray(sig), jprev, jcur, budget)
        tsel, tprev, tcur = tshadow.select_shadow_updates(t(sig), tprev, tcur, budget)
        assert (tsel.numpy() == np.asarray(jsel)).all()
        np.testing.assert_array_equal(tprev.numpy(), np.asarray(jprev))
        assert int(tcur) == int(jcur)


# --- signatures ------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 4])
def test_signature_dirties_the_same_units(k):
    """Static, moved caster (a nudge, then a jump), moved light: each frame's
    dirty units (any component changed from the frame before) match."""
    base = mixed_scene()
    sequence = [base, base, moved(base, box=(0.05, 0.8, 0.0)), moved(base, box=(-2.5, 0.8, 2.0)),
                moved(base, box=(-2.5, 0.8, 2.0), light=(0.2, -1.0, 0.8))]
    jprev = tprev = None
    dirty_seen = []
    for jscene in sequence:
        f = Frame(jscene)
        jsig = np.asarray(jshadow.shadow_signature(f.jscene, f.jmats, f.jscene.lights, f.jprep[0],
                                                   N_SLOTS, progressive=k))
        tsig = tshadow.shadow_signature(f.tscene, f.tmats, f.tprep.model, f.slots, progressive=k)
        assert tsig.shape == jsig.shape
        if jprev is not None:
            jd = (jsig != jprev).any(axis=-1)
            td = (tsig != tprev).any(dim=-1).numpy()
            assert (td == jd).all(), (td, jd)
            dirty_seen.append(int(jd.sum()))
        jprev, tprev = jsig, tsig
    assert dirty_seen[0] == 0 and all(d > 0 for d in dirty_seen[1:])
    if k > 1:
        assert dirty_seen[1] < 2 * k, "a nudged box dirties only some bands"


# --- the atlas -----------------------------------------------------------------------

def test_atlas_per_light_matches_jax():
    f = base_frame()
    assert f.slots[:2] == ((0, True), (1, False)) and f.slots[2:] == (None, None)
    got = port_atlas(f).numpy()
    want = jax_atlas(f)
    assert got.shape == want.shape == (N_SLOTS, S, S)
    for slot, what in ((0, "directional slot"), (1, "point slot")):
        assert (got[slot] < 1.0).mean() > 0.1, f"{what} rendered nothing"
        assert_depth_close(got[slot], want[slot], what)
    assert (got[1, 3 * (S // 4):] == 1.0).all() and (got[2:] == 1.0).all()


def test_band_renders_tile_the_whole_slot():
    """K = 4 band renders (each into atlas rows of its own) stacked equal
    the whole-slot render."""
    f = base_frame()
    k = 4
    whole = port_atlas(f)
    atlas = torch.ones_like(whole)
    for band in range(k):
        sel = torch.zeros((N_SLOTS, k), dtype=torch.bool)
        sel[0, band] = True
        atlas = port_atlas(f, selected=sel, atlas_prev=atlas, progressive=k)
    assert (atlas[0].numpy() < 1.0).mean() > 0.2
    assert_depth_close(atlas[0].numpy(), whole[0].numpy(), "bands against the whole slot")


def test_cached_atlas_matches_jax_over_frames():
    """Budget 1, four bands per directional slot, six frames with a moving
    caster: the same units render each frame and the atlases agree."""
    k = 4
    base = mixed_scene()
    jfn = jax.jit(lambda scene, mats, model, lod, smin, smax, prev: jshadow.render_shadow_atlas_cached(
        scene, mats, scene.lights, model, lod, N_SLOTS, S, CAP, prev, budget=1, progressive=k,
        use_pallas=True, pallas_interpret=True, scene_min=smin, scene_max=smax))
    jstate = (jnp.ones((N_SLOTS, S, S), jnp.float32),
              jnp.full((N_SLOTS, k, tshadow.SIG_C), jnp.nan, jnp.float32), jnp.int32(0))
    tstate = tshadow.initial_cache(N_SLOTS, S, k, CPU)
    rendered = []
    for frame in range(6):
        jscene = base if frame < 3 else moved(base, box=(0.3 * frame, 0.8, -0.2 * frame))
        f = Frame(jscene)
        _, jnew = jfn(f.jscene, f.jmats, f.jprep[0], f.jprep[4], f.jprep[5], f.jprep[6], jstate)
        _, tnew = tshadow.render_shadow_atlas_cached(
            f.tscene, f.tmats, f.tprep.model, f.tprep.lod, f.slots, S, CAP, tstate, budget=1,
            progressive=k, scene_min=f.tprep.scene_min, scene_max=f.tprep.scene_max)

        def units(new, old):  # the units whose signature this frame wrote
            new, old = np.asarray(new), np.asarray(old)
            return ~np.all((new == old) | (np.isnan(new) & np.isnan(old)), axis=-1)

        ju, tu = units(jnew[1], jstate[1]), units(tnew[1], tstate[1])
        assert (tu == ju).all(), (frame, tu, ju)
        assert int(tnew[2]) == int(jnew[2])
        rendered.append(int(ju.sum()))
        for slot in range(N_SLOTS):
            assert_depth_close(tnew[0][slot].numpy(), np.asarray(jnew[0][slot]),
                               f"frame {frame} slot {slot}")
        jstate, tstate = jnew, tnew
    assert rendered == [1] * 6, rendered


# --- lookup -------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["directional", "point"])
def test_shadow_occlusion_matches_jax(kind):
    """Receivers on the floor (in and out of the boxes' shadows), in the
    volume above it, far outside the slot and, for the point light, on
    the seams between cube faces, against the same atlas."""
    f = base_frame()
    atlas = jax_atlas(f)
    rng = np.random.default_rng(1 if kind == "point" else 2)
    li = 0 if kind == "directional" else 1
    n = 4096
    world = rng.uniform([-7, -0.5, -7], [7, 4, 7], (n, 3)).astype(np.float32)
    normal = rng.normal(size=(n, 3)).astype(np.float32)
    world[:2048, 1] = 0.0  # the floor, facing up
    normal[:2048] = (0.0, 1.0, 0.0)
    world[2048:2560, 0] = rng.choice([-40.0, 40.0], 512)  # outside the slot
    if kind == "point":  # on the seams between faces: |dx| == |dy| or |dy| == |dz|
        lp = np.asarray(f.jscene.lights.position[1])
        d = rng.normal(size=(512, 3)).astype(np.float32)
        d[:256, 1] = np.abs(d[:256, 0]) * np.sign(d[:256, 1])
        d[256:, 2] = np.abs(d[256:, 1]) * np.sign(d[256:, 2])
        world[-512:] = lp + d * 2.0
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    ndl = rng.uniform(0, 1, (1, n)).astype(np.float32)
    mats = np.asarray(f.jmats)[li]
    lpos = np.asarray(f.jscene.lights.position[li])
    want = np.asarray(jshadow.shadow_occlusion(
        jnp.asarray(world.T), jnp.asarray(ndl), jnp.asarray(mats), jnp.asarray(atlas[li]),
        normal=jnp.asarray(normal.T), is_point=(kind == "point"), light_pos=jnp.asarray(lpos)))
    got = tshadow.shadow_occlusion(t(world.T), t(ndl), t(mats), t(atlas[li]), normal=t(normal.T),
                                   is_point=(kind == "point"), light_pos=t(lpos)).numpy()
    assert got.shape == want.shape == (1, n)
    close = np.abs(got - want) <= 1e-6
    assert close.mean() >= 0.9999, f"{(~close).sum()} receivers differ"
    assert (got[0, :2048] < 0.5).sum() > 5, "no floor receiver in shadow"
    assert (got[0, 2048:2560] == 1.0).all() if kind == "directional" else True


# --- plan and Renderer ------------------------------------------------------------

@pytest.mark.parametrize("cache", [True, False])
def test_plan_matches_the_jax_plan(cache):
    from renderer_tpu.passes.pipeline import PipelineConfig as JaxConfig, forward_plan_cache
    from renderer_tpu_torch.passes.pipeline import PipelineConfig, build_forward_plan

    plans = forward_plan_cache(JaxConfig(width=128, height=64, shadow_cache=cache))
    for shadows in (False, True):
        for rt in (False, True):
            want = [p.name for p in plans.plan({"shadows": shadows, "rt": rt}).passes]
            got = build_forward_plan(PipelineConfig(width=128, height=64, shadow_cache=cache),
                                     shadows=shadows, rt=rt)
            assert [p.name for p in got] == want, (shadows, rt)


def test_renderer_latches_shadows_and_keeps_a_static_atlas():
    """The switch takes effect a frame later; the cached atlas renders on
    the first shadowed frame, stays bit for bit as the camera moves, and
    re-renders when an instance moves (``render(scene=...)``)."""
    from renderer_tpu_torch.models import textured_scene
    from renderer_tpu_torch.passes.pipeline import PipelineConfig
    from renderer_tpu_torch.runtime import Renderer
    from renderer_tpu_torch.scene import SceneLimits

    def cam(x):
        return Camera.create([x, 1.2, 4.0], fov_y=0.9, near=0.1, far=60.0, aspect=2.0, device=CPU)

    r = Renderer(textured_scene(SceneLimits.tiny(), 32, device=CPU),
                 PipelineConfig(width=128, height=64, tri_capacity=1024, shadow_size=S))
    base = r.render(cam(0.0))["image"]
    r.set_config(shadows=True)
    assert torch.equal(r.render(cam(0.0))["image"], base) and r.config.shadows
    assert torch.isnan(r.state["shadow_cache"][1]).all()  # the latched frame ran no shadow pass
    shadowed = r.render(cam(0.0))["image"]
    assert (shadowed < base).any()
    atlas, sig, _ = r.state["shadow_cache"]
    assert (atlas[0] < 1.0).any() and not torch.isnan(sig).any()
    r.render(cam(0.3))
    assert torch.equal(r.state["shadow_cache"][0], atlas) and torch.equal(r.state["shadow_cache"][1], sig)
    inst = r.scene.instances
    moved = r.scene._replace(instances=inst._replace(
        translation=inst.translation + torch.tensor([0.3, 0.0, 0.0])))
    r.render(cam(0.3), scene=moved)
    assert not torch.equal(r.state["shadow_cache"][0][0], atlas[0])
    assert not torch.equal(r.state["shadow_cache"][1][0], sig[0])
    assert PipelineConfig(width=128, height=64, shade_rate="quarter").shade_rate == "quarter"
    for bad in (dict(shadow_size=96), dict(shadow_progressive=4),
                dict(shadow_size=128, shadow_progressive=16, shadow_update_budget=1),
                dict(shade_rate="half")):
        with pytest.raises(ValueError):
            PipelineConfig(width=128, height=64, **bad)
