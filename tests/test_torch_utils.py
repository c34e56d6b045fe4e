"""The port's own copies of the JAX package's jax-free helpers, against
the originals: raster-spec constants, PNG writing, the sRGB encode and
PSNR (exact); PNG reading against PIL (exact)."""

import os

import numpy as np
from PIL import Image

from renderer_tpu.ops import raster_spec as jspec
from renderer_tpu.utils import image as jimage
from renderer_tpu_torch.ops import raster_spec as tspec
from renderer_tpu_torch.utils import image as timage

GOLDEN = os.path.join(os.path.dirname(__file__), "..", "assets", "golden")


def test_srgb_encode_matches_the_jax_package():
    x = np.random.default_rng(1).uniform(-0.1, 1.2, (17, 9, 3)).astype(np.float32)
    assert np.array_equal(timage.srgb_encode(x), jimage.srgb_encode(x))


def test_raster_spec_constants_match():
    for name in ("FRONT_DET_SIGN", "DEPTH_CLEAR", "NO_TRIANGLE"):
        assert getattr(tspec, name) == getattr(jspec, name), name


def test_png_matches_the_jax_package(tmp_path):
    rng = np.random.default_rng(0)
    for c in (3, 4):
        img = rng.uniform(-0.2, 1.2, size=(37, 53, c)).astype(np.float32)
        timage.write_png(str(tmp_path / f"port{c}.png"), img)
        jimage.write_png(str(tmp_path / f"jax{c}.png"), img)
        got = np.asarray(Image.open(tmp_path / f"port{c}.png"))
        want = np.asarray(Image.open(tmp_path / f"jax{c}.png"))
        assert got.shape == (37, 53, c) and np.array_equal(got, want)


def test_psnr_matches_the_jax_package():
    rng = np.random.default_rng(1)
    a = rng.uniform(size=(16, 16, 3))
    b = a + rng.normal(scale=1e-2, size=a.shape)
    assert timage.psnr(a, b) == jimage.psnr(a, b)
    assert timage.psnr(a, a) == float("inf")


def test_read_png_matches_pil(tmp_path):
    """The committed goldens (RGB, Sub/Up/Paeth rows) and the port's own
    RGBA and RGB output decode as PIL decodes them."""
    paths = [os.path.join(GOLDEN, f"shadowed_pose{i}.png") for i in range(3)]
    rng = np.random.default_rng(2)
    for c in (3, 4):
        path = str(tmp_path / f"port{c}.png")
        timage.write_png(path, rng.uniform(size=(29, 41, c)).astype(np.float32))
        paths.append(path)
    for path in paths:
        want = np.asarray(Image.open(path))
        got = timage.read_png(path)
        assert got.dtype == np.uint8 and got.shape == want.shape and np.array_equal(got, want), path
