"""Edge cases of the plain configuration's kernels (the count-bounded scan
raster, ``csrc/scan_raster.cu``, and the brute-force rt,
``csrc/rt_brute.cu``), built with numpy alone from seeds.

Each case is used twice: on the CPU, the port's plain version against the
JAX package (tests/test_torch_plain_kernel_cases.py), and on the card, the
kernel against the plain version bit for bit (tests/test_torch_kernels.py).

The raster kernel bins the soup into 32 x 32 pixel cells, walks 32 x 8
pixel regions (16 x 4 on a small image) with a pixel per lane, gathers 128
triangles at a time and keeps the least (z, id); the brute-force kernel
walks 16 x 8 tiles of receivers, four per lane, against blocks of 128
triangles, and culls a triangle by the tile's bounding box. The cases sit
on those edges:

- ``ties``: three copies of a triangle at one depth in three blocks (ids
  5, 133, 261) and a second shape at that depth (ids 40 and 170): the
  lowest id wins every shared pixel;
- ``many_hits``: 400 small triangles piled on a 13 x 5 pixel patch inside
  one region (of either shape), so its stages of 128 all hit;
- ``odd_size``: a 97 x 45 image, a multiple of neither the regions nor the
  cells, with triangles of every size and some crossing w = 0;
- ``small_capacity``: a soup of 100 slots (one block of 100), so the last
  group of 32 is cut at 4;
- ``odd_receivers``: 23 x 43 receivers, a multiple of neither the tile nor
  a lane's four;
- ``occluded_and_lit``: a floor under a quad that shades its left part
  whole and leaves its right part in the open, so whole tiles are occluded
  and whole tiles lit.
"""

import numpy as np


def _clip(px_tris, z, width: int, height: int) -> np.ndarray:
    """(n, 3, 4) clip corners of pixel-space triangles at depths z, w = 1."""
    t = np.asarray(px_tris, np.float32)
    clip = np.zeros(t.shape[:2] + (4,), np.float32)
    clip[..., 0] = t[..., 0] / width * 2.0 - 1.0
    clip[..., 1] = 1.0 - t[..., 1] / height * 2.0
    clip[..., 2] = np.asarray(z, np.float32)[:, None]
    clip[..., 3] = 1.0
    return clip


def _slots(clip: np.ndarray, ids, capacity: int):
    """A soup of ``capacity`` slots holding ``clip``'s triangles at ``ids``."""
    out = np.zeros((capacity, 3, 4), np.float32)
    valid = np.zeros(capacity, bool)
    out[ids] = clip
    valid[ids] = True
    return out, valid


def ties_soup():
    w, h = 128, 64
    big = [(30.0, 8.0), (100.0, 12.0), (60.0, 56.0)]
    other = [(50.0, 20.0), (120.0, 30.0), (70.0, 62.0)]
    rng = np.random.default_rng(21)
    filler = rng.uniform([0, 0], [w, h], size=(60, 3, 2))
    tris = [big, big, big, other, other] + list(filler)
    z = [0.5] * 5 + list(rng.uniform(0.55, 0.95, 60))
    ids = [5, 133, 261, 40, 170] + [i for i in range(300, 384) if i % 7][:60]
    return _slots(_clip(tris, z, w, h), ids, 384)


def many_hits_soup(w: int = 128, h: int = 64):
    rng = np.random.default_rng(22)
    corner = rng.uniform([17, 12], [27, 14], size=(400, 1, 2))
    tris = corner + rng.uniform(0, 3, size=(400, 3, 2))
    return _slots(_clip(tris, rng.uniform(0.1, 0.9, 400), w, h), np.arange(400), 512)


def odd_size_soup():
    w, h = 97, 45
    rng = np.random.default_rng(23)
    centre = rng.uniform([-10, -10], [w + 10, h + 10], size=(230, 1, 2))
    size = rng.choice([2.0, 8.0, 30.0, 120.0], size=(230, 1, 1))
    clip = _clip(centre + size * rng.uniform(-1, 1, size=(230, 3, 2)),
                 rng.uniform(0.05, 0.95, 230), w, h)
    clip[::23, 1, 3] = -0.2  # a corner behind the eye
    return _slots(clip, np.arange(230), 256)


def small_capacity_soup():
    w, h = 64, 40
    rng = np.random.default_rng(24)
    corner = rng.uniform([0, 0], [w, h], size=(90, 1, 2))
    tris = corner + rng.uniform(-12, 12, size=(90, 3, 2))
    return _slots(_clip(tris, rng.uniform(0.1, 0.9, 90), w, h), np.arange(90), 100)


# name -> (soup builder, width, height, cull_backface, counts)
RASTER_CASES = {
    "ties": (ties_soup, 128, 64, False, (1, 6, 128, 129, 134, 261, 262, 384)),
    "many_hits": (many_hits_soup, 128, 64, False, (0, 100, 128, 129, 200, 400, 512)),
    "odd_size": (odd_size_soup, 97, 45, False, (0, 1, 31, 32, 33, 127, 128, 129, 255, 256)),
    "small_capacity": (small_capacity_soup, 64, 40, True, (0, 1, 31, 32, 33, 64, 99, 100)),
}
TIE_IDS = ((5, 133, 261), (40, 170))  # ties_soup's copies at one depth, lowest first
# an image whose cells' lists hold 256 triangles each (2^23 entries over
# 256 x 128 cells), so many_hits' cell passes its capacity and the kernel
# walks that region from the group boxes
OVERFLOW_SIZE = (8192, 4096)


def odd_receivers_case():
    """Receivers (3, 23, 43) over a slab, normals, and 600 triangles above
    them in 768 slots."""
    rng = np.random.default_rng(25)
    world = rng.uniform(-2, 2, (3, 23, 43)).astype(np.float32)
    world[1] *= 0.1
    normal = rng.normal(size=(3, 23, 43)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=0, keepdims=True)
    tri = np.zeros((768, 3, 3), np.float32)
    centres = rng.uniform(-2, 2, (600, 1, 3)) * np.float32([1, 0.5, 1]) + np.float32([0, 1.5, 0])
    tri[:600] = centres + rng.normal(scale=0.15, size=(600, 3, 3))
    valid = np.zeros(768, bool)
    valid[:600] = rng.random(600) < 0.9
    return world, normal, np.float32([-0.3, -1.0, 0.5]), tri, valid


def occluded_and_lit_case():
    """A floor of (3, 24, 48) receivers on y = 0 under a quad at y = 1 over
    x < -0.5 (the light straight down), 2 live triangles in 128 slots."""
    x, z = np.meshgrid(np.linspace(-3, 3, 48, dtype=np.float32),
                       np.linspace(-1.5, 1.5, 24, dtype=np.float32))
    world = np.stack([x, np.zeros_like(x), z])
    normal = np.stack([np.zeros_like(x), np.ones_like(x), np.zeros_like(x)])
    tri = np.zeros((128, 3, 3), np.float32)
    tri[0] = [(-4.0, 1.0, -3.0), (-0.5, 1.0, -3.0), (-0.5, 1.0, 3.0)]
    tri[1] = [(-4.0, 1.0, -3.0), (-0.5, 1.0, 3.0), (-4.0, 1.0, 3.0)]
    valid = np.zeros(128, bool)
    valid[:2] = True
    return world, normal, np.float32([0.0, -1.0, 0.0]), tri, valid


# name -> (case builder, counts)
BRUTE_CASES = {
    "odd_receivers": (odd_receivers_case, (0, 1, 129, 600, 768)),
    "occluded_and_lit": (occluded_and_lit_case, (0, 1, 2, 128)),
}
