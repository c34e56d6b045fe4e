"""The culling switches (freeze culling, the debug-AABB view, cluster
culling, occlusion culling) against the JAX package: their modules on the
same inputs and their plans.

Gates, with their reasons:
- aabb_soup + compact_soup: count, instance and valid exact, clip and
  normals within 1e-6 (rtol and atol; the same products, summed in XLA's
  einsum order);
- instance_debug_colors within 1e-6;
- _cluster_slot_map: owner, tri_idx and valid exact (integer slot maps of
  the same cull decisions);
- soup_from_draw_list within 1e-6 of each triangle's largest magnitude
  (a clip coordinate near 0 is a difference of terms near 100, summed
  in another order by XLA's einsum), finalize_tex_lod
  within rtol 1e-6 (0.5 * log2 may differ by an ulp between the two
  frameworks), build_shade_records with render_size on the same soup
  within rtol 1e-6 of each column's largest magnitude (the edge columns
  are differences of products of pixel-scale coordinates);
- the plan of every switch set equal to the JAX plan's passes.

The switches' frames against the JAX Renderer are in
test_torch_culling_frames.py.

The JAX functions run op by op (not jitted), as in test_torch_geometry.py.
"""

import functools
import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from renderer_tpu.models import sponza_like_scene as jax_sponza
from renderer_tpu.models.scenes import city_scene as jax_city
from renderer_tpu.ops import debug as jdbg, geometry as jgeo
from renderer_tpu.ops.cull import compact_soup as jax_compact
from renderer_tpu.passes.pipeline import PipelineConfig as JaxConfig, forward_plan_cache
from renderer_tpu.scene.types import as_numpy_scene
from renderer_tpu_torch.mathx import Camera
from renderer_tpu_torch.ops import debug as tdbg, geometry as tgeo
from renderer_tpu_torch.ops.cull import compact_soup
from renderer_tpu_torch.passes.pipeline import PipelineConfig, build_forward_plan
from renderer_tpu_torch.runtime import Renderer
from renderer_tpu_torch.scene import scene_from_numpy

BACK = (0.0, 1.0, 0.0, 0.0)  # turned by 180 degrees about y: looking along +z


def cam_args(w, h):
    return dict(fov_y=0.9, near=0.1, far=60.0, aspect=w / h)


@functools.lru_cache(maxsize=None)
def scenes(name):
    """(JAX scene, the port's copy of it)."""
    jscene = jax_sponza(64) if name == "sponza" else jax_city(3)
    return jscene, scene_from_numpy(as_numpy_scene(jscene), device="cpu")


@functools.lru_cache(maxsize=None)
def prepared(pos, rot=None, w=256, h=64, which="sponza"):
    return tgeo.prepare_frame_columns(scenes(which)[1],
                                      Camera.create(pos, rot, **cam_args(w, h), device="cpu"))


def jnp_of(t):
    return jnp.asarray(t.numpy())


@pytest.mark.parametrize("capacity", [512, 1024])  # cut (65 boxes x 12 > 512) and padded
def test_aabb_soup_compacted_matches_jax(capacity):
    jscene, scene = scenes("sponza")
    prep = prepared((4.0, 6.0, 18.0))
    got = compact_soup(tdbg.aabb_soup(scene, prep.visible, prep.clip_mats, prep.model, capacity))
    want = jax_compact(jdbg.aabb_soup(jscene, jnp_of(prep.visible), jnp_of(prep.clip_mats),
                                      jnp_of(prep.model), capacity))
    assert 0 < int(got.count) == int(want.count) < capacity
    for f in ("instance", "valid", "tri_idx"):
        assert np.array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f))), f
    for f in ("clip", "normal", "uv", "tangent"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=1e-6, atol=1e-6, err_msg=f)


def test_instance_debug_colors_match_jax():
    ids = np.concatenate([np.arange(5000), [65535, 1 << 20]]).astype(np.int32)
    got = tdbg.instance_debug_colors(torch.from_numpy(ids).long()).numpy()
    want = np.asarray(jdbg.instance_debug_colors(jnp.asarray(ids)))
    assert got.shape == want.shape == (ids.size, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("cull_backface", [True, False])
def test_cluster_slot_map_matches_jax(cull_backface):
    """The city's buildings: flat 9-cluster faces, whose cones are exact."""
    jscene, scene = scenes("city")
    prep = prepared((4.0, 2.0, 20.0), which="city")
    expand = 32768
    got = tgeo._cluster_slot_map(scene, prep.visible, prep.lod, expand, prep.model,
                                 prep.camera_pos, prep.vp, cull_backface)
    want = jgeo._cluster_slot_map(jscene, jnp_of(prep.visible), jnp_of(prep.lod), expand,
                                  jnp_of(prep.model), jnp_of(prep.camera_pos), jnp_of(prep.vp),
                                  cull_backface)
    for name, g, w in zip(("owner", "tri_idx", "valid"), got, want):
        assert np.array_equal(g.numpy(), np.asarray(w)), name
    demand = int(tgeo.expansion_demand(scene, prep.visible, prep.lod))
    kept = int(got[2].sum())
    assert 0 < kept <= demand and (kept < demand or not cull_backface)  # cones cull faces
    assert int(tgeo.cluster_budget_overflow(scene, prep.visible, prep.lod, expand)) == int(
        jgeo.cluster_budget_overflow(jscene, jnp_of(prep.visible), jnp_of(prep.lod), expand))


def test_frozen_soup_and_shade_records_match_jax():
    """A draw list culled at one pose, re-expanded at a pose behind it and
    turned around (the freeze path's inputs)."""
    jscene, scene = scenes("sponza")
    w, h = 256, 64
    soup, _ = tgeo.build_draw_stream(scene, prepared((4.0, 6.0, 18.0)), 8192, 4096, w, h)
    dl = tgeo.DrawList(soup.instance, soup.tri_idx, soup.valid, soup.count)
    prep = prepared((4.0, 6.0, -6.0), BACK)
    got = tgeo.soup_from_draw_list(scene, dl, prep.clip_mats, prep.model)
    got = tgeo.finalize_tex_lod(got, w, h, scene.atlas.level_size[0])
    jdl = jgeo.DrawList(*(jnp_of(t) for t in dl))
    want = jgeo.soup_from_draw_list(jscene, jdl, jnp_of(prep.clip_mats), jnp_of(prep.model))
    want = jgeo.finalize_tex_lod(want, w, h, jscene.atlas.level_size[0])
    w_clip = np.asarray(want.clip)[:, :, 3]
    n = int(dl.count)
    assert (w_clip[:n] <= 0).any(axis=1).sum() > 10, "no frozen triangle reaches behind the eye"
    for f in ("clip", "normal", "uv", "tangent"):  # against each triangle's largest magnitude
        g, wt = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        scale = np.abs(wt).reshape(len(wt), -1).max(axis=1)[:, None, None]
        assert (np.abs(g - wt) <= 1e-6 * scale).all(), f
    np.testing.assert_allclose(got.tex_lod.numpy(), np.asarray(want.tex_lod), rtol=1e-6, atol=0)
    assert (got.tex_lod.numpy() > 0).sum() > 100
    # the records of the same soup
    rec = tgeo.build_shade_records(got, scene, render_size=(w, h)).numpy()
    jsoup = want._replace(**{f: jnp_of(getattr(got, f))
                             for f in ("clip", "normal", "uv", "tangent", "tex_lod")})
    jrec = np.asarray(jgeo.build_shade_records(jsoup, jscene, render_size=(w, h)))
    assert rec.shape == jrec.shape == (4096, tgeo.SR_COLS)
    scale = np.abs(jrec).max(axis=0)
    assert (np.abs(rec - jrec) <= 1e-6 * scale).all()


SWITCHES = ("freeze_culling", "debug_aabbs", "shadows", "occlusion_culling", "rt", "hud",
            "reference_image")


@pytest.mark.parametrize("cache", [True, False])
def test_plans_match_the_jax_plans(cache):
    """Every switch set, with and without SSAA. The reference view has no
    shade records under debug_aabbs, so with reference_image on and hud off
    no pass writes the image: the JAX plan then drops it from the outputs,
    the port's raises."""
    for ssaa in (1, 2):
        plans = forward_plan_cache(JaxConfig(width=128, height=64, shadow_cache=cache, ssaa=ssaa))
        cfg = PipelineConfig(width=128, height=64, shadow_cache=cache, ssaa=ssaa)
        for values in itertools.product((False, True), repeat=len(SWITCHES)):
            switches = dict(zip(SWITCHES, values))
            want = [p.name for p in plans.plan(switches).passes]
            if switches["debug_aabbs"] and switches["reference_image"] and not switches["hud"]:
                assert "shade_debug" not in want
                with pytest.raises(ValueError, match="written by no pass"):
                    build_forward_plan(cfg, outputs=("image", "vis"), **switches)
                continue
            got = build_forward_plan(cfg, outputs=("image", "vis"), **switches)
            assert [p.name for p in got] == want, switches


def test_unported_switches_still_raise():
    """Every switch of the JAX package is ported: hud and reference_image
    are taken, a switch neither package has raises."""
    r = Renderer(scenes("sponza")[1], PipelineConfig(width=128, height=64))
    r.set_config(hud=True, reference_image=True)
    for switch in ("spmd", "watch"):
        with pytest.raises(AttributeError, match="unknown runtime switch"):
            r.set_config(**{switch: True})


def test_occlusion_plan_needs_the_pyramid_sizes():
    """The 6-level pyramid halves the depth buffer 6 times."""
    build_forward_plan(PipelineConfig(width=128, height=64), occlusion_culling=True)
    with pytest.raises(ValueError, match="divisible by 64"):
        build_forward_plan(PipelineConfig(width=128, height=80), occlusion_culling=True)
    build_forward_plan(PipelineConfig(width=128, height=80))  # no pyramid without the switch
