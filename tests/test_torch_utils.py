"""The port's own copies of the JAX package's jax-free helpers, against
the originals: raster-spec constants, PNG writing, the sRGB encode and
PSNR (exact); PNG reading of every 8-bit colour type and the bilinear
resize against PIL (exact), and the texture builder's resize against the
JAX builder's (exact)."""

import os

import numpy as np
import pytest
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


def _png_of_each_colour_type(rng):
    """PNG bytes (Pillow's encoder) of every colour type glTF images use:
    grey, grey+alpha, RGB, RGBA, palette, palette with tRNS (8-bit), and a
    4-bit palette with tRNS."""
    import io

    h, w = 19, 27
    out = {}
    for mode in ("L", "LA", "RGB", "RGBA", "P", "P+tRNS", "P4+tRNS"):
        kw = {}
        if mode.startswith("P"):
            im = Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).quantize(
                9 if mode == "P4+tRNS" else 37)
            if mode.endswith("tRNS"):
                kw["transparency"] = bytes(rng.integers(0, 256, 20, dtype=np.uint8))
        else:
            c = len(mode)
            a = rng.integers(0, 256, (h, w, c), dtype=np.uint8)
            im = Image.fromarray(a[..., 0] if c == 1 else a, mode)
        buf = io.BytesIO()
        im.save(buf, "PNG", **kw)
        out[mode] = buf.getvalue()
    return out


def test_read_png_each_colour_type_matches_pil(tmp_path):
    """Grey, grey+alpha, RGB, RGBA and palette (8-bit with and without tRNS,
    4-bit with) decode as Pillow decodes them: the stored channels equal Pillow's
    array, and as_rgba equals Pillow's convert("RGBA")."""
    import io

    for mode, data in _png_of_each_colour_type(np.random.default_rng(3)).items():
        path = tmp_path / f"{mode}.png"
        path.write_bytes(data)
        got = timage.read_png(str(path))
        pil = Image.open(io.BytesIO(data))
        want = np.asarray(pil.convert("RGB" if mode == "P" else "RGBA" if mode.endswith("tRNS")
                                      else pil.mode))
        assert got.dtype == np.uint8 and got.reshape(want.shape).tolist() == want.tolist(), mode
        assert np.array_equal(timage.as_rgba(got), np.asarray(pil.convert("RGBA"))), mode
        assert np.array_equal(timage.decode_png(data), got), mode


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA"])
def test_resize_bilinear_matches_pil_bit_for_bit(mode):
    """Up- and down-scales of odd sizes, and the 512 -> 256 texture case, as
    Pillow's Image.resize(size, BILINEAR) gives them (RGBA and LA through
    premultiplied alpha)."""
    rng = np.random.default_rng(len(mode))
    for h, w in ((17, 23), (37, 5), (300, 211), (512, 512)):
        img = rng.integers(0, 256, (h, w, len(mode)), dtype=np.uint8)
        if mode in ("LA", "RGBA"):  # opaque, clear and partial alpha all present
            img[..., -1][rng.random((h, w)) < 0.3] = 255
            img[..., -1][rng.random((h, w)) < 0.1] = 0
        img = img[..., 0] if mode == "L" else img
        pil = Image.fromarray(img, mode)
        for size in ((256, 256), (8, 8), (13, 41), (3 * w, 2 * h), (w, 7), (5, h)):
            want = np.asarray(pil.resize(size, Image.BILINEAR))
            got = timage.resize_bilinear_u8(img, size)
            assert got.shape == want.shape and np.array_equal(got, want), (mode, h, w, size)


def test_add_texture_resizes_as_the_jax_builder():
    """The repair: SceneBuilder.add_texture with a 512x512 image gives the
    JAX builder's texels (Pillow there), without Pillow in the port."""
    from renderer_tpu.scene import SceneBuilder as JaxBuilder, SceneLimits as JaxLimits
    from renderer_tpu_torch.scene import SceneBuilder, SceneLimits

    rng = np.random.default_rng(7)
    rgba = rng.integers(0, 256, (512, 512, 4), dtype=np.uint8)
    rgba[..., 3][rng.random((512, 512)) < 0.5] = 255
    images = [rgba, rng.integers(0, 256, (512, 512, 3), dtype=np.uint8),
              rng.uniform(0, 1, (100, 60, 3)).astype(np.float32)]
    jb, tb = JaxBuilder(JaxLimits.tiny()), SceneBuilder(SceneLimits.tiny())
    for img in images:
        assert jb.add_texture(img) == tb.add_texture(img)
    for got, want in zip(tb.atlas.layers, jb.atlas.layers):
        assert got.shape == (256, 256, 4) and np.array_equal(got, want)
    assert np.array_equal(tb.atlas.build().packed_u32, np.asarray(jb.atlas.build().packed_u32))
