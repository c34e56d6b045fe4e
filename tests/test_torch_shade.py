"""The port's shading (texture sampling, PBR, edge AA) against the JAX
package's, on the same visibility buffer and shade records.

Gates: texture samples within atol 1e-5 (float32 bilinear weights; the JAX
sampler reads its quad table, the port reads texels tap by tap, the same
taps and weights); shade_pbr and edge_aa within atol 1e-4 (float32 GGX on
HDR values summed in other orders). The JAX side is jitted: these
comparisons carry tolerances, and op-by-op JAX is slow on the CPU.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from renderer_tpu.mathx.camera import Camera as JaxCamera
from renderer_tpu.models import sponza_like_scene as jax_sponza, textured_scene as jax_textured
from renderer_tpu.ops import aa as jaa, geometry as jgeo, pbr as jpbr, texture as jtex
from renderer_tpu.ops.raster_jax import rasterize
from renderer_tpu.scene import SceneLimits as JaxLimits
from renderer_tpu.scene.types import as_numpy_scene
from renderer_tpu_torch.ops import aa as taa, pbr as tpbr, texture as ttex
from renderer_tpu_torch.ops.raster_cuda import VisibilityBuffer
from renderer_tpu_torch.scene import scene_from_numpy

SCENES = {
    "textured": (lambda: jax_textured(JaxLimits.tiny(), 32), [0.0, 1.2, 4.0], 128, 64),
    "sponza": (lambda: jax_sponza(64), [4.0, 6.0, 18.0], 256, 64),
}


@pytest.mark.parametrize("trilinear", [True, False])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_sample_atlas_matches_jax(name, trilinear):
    jscene = SCENES[name][0]()
    atlas = scene_from_numpy(as_numpy_scene(jscene), device="cpu").atlas
    rng = np.random.default_rng(4)
    n = 4096
    layer = rng.integers(-1, int(jscene.atlas.n_layers), size=n).astype(np.int32)
    u = rng.uniform(-2.0, 3.0, n).astype(np.float32)
    v = rng.uniform(-2.0, 3.0, n).astype(np.float32)
    lod = rng.uniform(-1.0, 8.0, n).astype(np.float32)
    for lod_in in (lod, None):
        want = jtex.sample_atlas_cf(
            jscene.atlas, jnp.asarray(layer), jnp.asarray(u), jnp.asarray(v),
            None if lod_in is None else jnp.asarray(lod_in), trilinear=trilinear,
        )
        got = ttex.sample_atlas_cf(
            atlas, torch.from_numpy(layer), torch.from_numpy(u), torch.from_numpy(v),
            None if lod_in is None else torch.from_numpy(lod_in), trilinear=trilinear,
        )
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    c = rng.uniform(0, 1, 257).astype(np.float32)
    np.testing.assert_allclose(ttex.srgb_to_linear(torch.from_numpy(c)).numpy(),
                               np.asarray(jtex.srgb_to_linear(jnp.asarray(c))), atol=1e-6)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_shade_pbr_and_edge_aa_match_jax(name):
    build, pos, w, h = SCENES[name]
    jscene = build()
    tscene = scene_from_numpy(as_numpy_scene(jscene), device="cpu")
    cam = JaxCamera.create(jnp.asarray(pos), fov_y=0.9, near=0.1, far=60.0, aspect=w / h)
    prep = jax.jit(jgeo.prepare_frame_columns)(jscene, cam)
    soup, rec = jax.jit(jgeo.build_draw_stream, static_argnums=(5, 6, 7, 8))(
        jscene, prep[3], prep[4], prep[2], prep[0], 8192, 4096, w, h, vp=prep[1])
    vis = jax.jit(rasterize, static_argnums=(2, 3))(soup.clip, soup.valid, w, h)
    n_lights = int(jscene.lights.count)
    kw = dict(background=(0.05, 0.05, 0.08), enable_textures=True, enable_normal_maps=True,
              trilinear=False, light_slots=n_lights)
    want = jax.jit(functools.partial(jpbr.shade_pbr, bary_from_records=True, **kw))(
        vis, rec, jscene, cam.position, viewproj_inv=prep[7])
    tvis = VisibilityBuffer(*(torch.from_numpy(np.array(a)) for a in vis))
    trec = torch.from_numpy(np.array(rec))
    args = (tvis, trec, tscene, torch.from_numpy(np.array(pos, np.float32)),
            torch.from_numpy(np.array(prep[7])))
    got = tpbr.shade_pbr(*args, **kw)
    covered = (np.asarray(vis.tri_id) >= 0).mean()
    assert 0.2 < covered < 1.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)

    # edge AA on the same HDR colour and ids
    color = np.moveaxis(np.asarray(want), -1, 0)
    want_aa = jax.jit(jaa.edge_aa)(jnp.asarray(color), vis.tri_id)
    got_aa = taa.edge_aa(torch.from_numpy(np.array(color)), tvis.tri_id)
    np.testing.assert_allclose(got_aa.numpy(), np.asarray(want_aa), atol=1e-4)
    assert np.abs(np.asarray(want_aa) - color).max() > 1e-3  # AA changed something
    np.testing.assert_allclose(tpbr.shade_pbr(*args, aa=True, **kw).numpy(),
                               np.moveaxis(np.asarray(want_aa), 0, -1), atol=1e-4)
