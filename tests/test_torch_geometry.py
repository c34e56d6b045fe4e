"""The port's geometry stage (renderer_tpu_torch/ops/geometry.py) against the
JAX package's, on the same scenes and cameras.

Gates: prepare_frame_columns' visibility and LOD exact, its matrices within
1e-5; build_draw_stream's survivor count exact, the same set of (instance,
library triangle) pairs, and shade records matched by pair within
rtol 1e-5, atol 1e-4 (the edge columns are products of pixel-scale
coordinates). Pairs, not slots, are compared: slot order follows the Morton
keys, which the two frameworks may round differently near a cell seam.

The JAX functions run op by op (not jitted): like PyTorch's eager ops they
then round every product and sum, while XLA's fused code may contract them
into FMAs and so cull a borderline triangle differently.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from renderer_tpu.mathx.camera import Camera as JaxCamera
from renderer_tpu.models import sponza_like_scene as jax_sponza, textured_scene as jax_textured
from renderer_tpu.ops import geometry as jgeo
from renderer_tpu.scene import SceneLimits as JaxLimits
from renderer_tpu.scene.types import as_numpy_scene
from renderer_tpu_torch.mathx import Camera
from renderer_tpu_torch.ops import geometry as tgeo
from renderer_tpu_torch.scene import scene_from_numpy

# name -> (JAX scene builder, camera position, width, height, tri capacity)
SETUPS = {
    "textured": (lambda: jax_textured(JaxLimits.tiny(), 32), [0.0, 1.2, 4.0], 128, 64, 8192),
    "sponza": (lambda: jax_sponza(64), [4.0, 6.0, 18.0], 256, 64, 4096),
}


@functools.lru_cache(maxsize=None)
def setup(name):
    build, pos, w, h, cap = SETUPS[name]
    jscene = build()
    tscene = scene_from_numpy(as_numpy_scene(jscene), device="cpu")
    cam = dict(fov_y=0.9, near=0.1, far=60.0, aspect=w / h)
    jprep = jgeo.prepare_frame_columns(jscene, JaxCamera.create(jnp.asarray(pos), **cam))
    tprep = tgeo.prepare_frame_columns(tscene, Camera.create(pos, **cam, device="cpu"))
    return jscene, tscene, jprep, tprep, w, h, cap


@pytest.mark.parametrize("name", sorted(SETUPS))
def test_prepare_frame_columns_matches_jax(name):
    _, _, jprep, tprep, *_ = setup(name)
    model, vp, clip_mats, visible, lod = (np.asarray(a) for a in jprep[:5])
    assert visible.any() and not visible.all()
    assert (tprep.visible.numpy() == visible).all()
    assert (tprep.lod.numpy() == lod).all()
    for got, want in ((tprep.model, model), (tprep.vp, vp), (tprep.clip_mats, clip_mats),
                      (tprep.vp_inv, np.asarray(jprep[7]))):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize(
    "name, cull_backface", [("textured", True), ("textured", False), ("sponza", True)]
)
def test_build_draw_stream_matches_jax(name, cull_backface):
    jscene, tscene, jprep, tprep, w, h, cap = setup(name)
    jsoup, jrec = jgeo.build_draw_stream(
        jscene, jprep[3], jprep[4], jprep[2], jprep[0], 2 * cap, cap, w, h,
        cull_backface=cull_backface, vp=jprep[1],
    )
    tsoup, trec = tgeo.build_draw_stream(tscene, tprep, 2 * cap, cap, w, h,
                                         cull_backface=cull_backface)
    n = int(tsoup.count)
    assert n == int(jsoup.count) and 0 < n < cap
    assert tsoup.valid.numpy().sum() == n

    def by_pair(soup, rec):
        """(instance, library triangle) -> shade record + clip corners."""
        inst = np.asarray(soup.instance)[:n].astype(np.int64)
        tri = np.asarray(soup.tri_idx)[:n].astype(np.int64)
        rows = np.concatenate([np.asarray(rec)[:n], np.asarray(soup.clip)[:n].reshape(n, 12)], 1)
        return dict(zip(zip(inst, tri), rows))

    got, want = by_pair(tsoup, trec), by_pair(jsoup, jrec)
    assert len(got) == n and got.keys() == want.keys()
    keys = sorted(got)
    np.testing.assert_allclose(np.stack([got[k] for k in keys]),
                               np.stack([want[k] for k in keys]), rtol=1e-5, atol=1e-4)


def test_slot_map_matches_jax():
    rng = np.random.default_rng(2)
    counts = rng.integers(0, 5, size=37).astype(np.int32)
    counts[[0, 5, 6]] = 0
    cap = int(counts.sum()) - 3  # truncating capacity
    want = jgeo._slot_map_starts(jnp.asarray(counts), cap)
    got = tgeo._slot_map_starts(torch.from_numpy(counts), cap)
    for g, w in zip(got[:4], want[:4]):
        assert (g.numpy() == np.asarray(w)).all()
    assert int(got[4]) == int(want[4])
