"""Occlusion test cases: casters in light clip space and receivers in light
NDC, built with numpy from a seed (no jax, nothing of the JAX package).

Shared by the CPU tests (the port's plain version against JAX and a
float64 brute force), the card tests and chip_smoke.py (the kernel against
the plain version). Each case gives (clip (T, 3, 4) f32, valid (T,) bool,
lx, ly, ld (H, W) f32), ld = +inf marking background receivers.
"""

import numpy as np


def casters(seed, n=512, cap=1024, persp=False, cross=0.0, size=(0.05, 0.5), area=(-1.1, 1.1)):
    """n random triangles (T = cap slots): NDC centres in ``area``^2,
    sizes in ``size``, depths in (0, 1); ``persp`` scales each corner by a
    random w in [0.3, 3]; a ``cross`` share has one corner behind the light
    (w < 0)."""
    rng = np.random.default_rng(seed)
    centre = rng.uniform(*area, (n, 1, 2))
    size = rng.uniform(*size, (n, 1, 1))
    clip = np.zeros((cap, 3, 4), np.float32)
    clip[:n, :, :2] = centre + size * rng.uniform(-1.0, 1.0, (n, 3, 2))
    clip[:n, :, 2] = rng.uniform(0.05, 0.95, (n, 1)) + rng.uniform(-0.05, 0.05, (n, 3))
    clip[:n, :, 3] = 1.0
    if persp:
        clip[:n] *= rng.uniform(0.3, 3.0, (n, 3, 1)).astype(np.float32)
    behind = np.zeros(cap, bool)
    behind[:n] = rng.random(n) < cross
    clip[behind, 0, 3] = -0.2
    valid = np.zeros(cap, bool)
    valid[:n] = rng.random(n) < 0.95
    return clip, valid


def receivers(seed, h, w, background=0.2):
    """Uniform light NDC in [-1.2, 1.2]^2 and depth in [0, 1], a
    ``background`` share with ld = +inf (plus a block of background
    receivers, so some tiles have no live receiver)."""
    rng = np.random.default_rng(seed)
    lx = rng.uniform(-1.2, 1.2, (h, w)).astype(np.float32)
    ly = rng.uniform(-1.2, 1.2, (h, w)).astype(np.float32)
    ld = rng.uniform(0.0, 1.0, (h, w)).astype(np.float32)
    ld[rng.random((h, w)) < background] = np.inf
    ld[: h // 2, : w // 2] = np.inf
    return lx, ly, ld


def surface(seed, h, w, background=0.2):
    """Receivers on a smooth light-space surface, as a rendered frame gives
    them: lx and ly follow the columns and rows across [-1.2, 1.2] with a
    gentle wobble and the depth varies smoothly in [0.2, 0.8], so each
    tile's receivers span a small light-space bbox. Background as in
    ``receivers``."""
    rng = np.random.default_rng(seed)
    u = np.linspace(-1.2, 1.2, w)[None, :]
    v = np.linspace(-1.2, 1.2, h)[:, None]
    lx = (u + 0.02 * np.sin(3.0 * v)).astype(np.float32)
    ly = (v + 0.02 * np.cos(2.0 * u)).astype(np.float32)
    ld = (0.5 + 0.3 * np.sin(2.0 * lx) * np.cos(3.0 * ly)).astype(np.float32)
    ld[rng.random((h, w)) < background] = np.inf
    ld[: h // 2, : w // 2] = np.inf
    return lx, ly, ld


def case(caster_kw, h, w, seed):
    return casters(seed, **caster_kw) + receivers(seed + 100, h, w)


def coherent_tiles(seed=6, h=64, w=128):
    """Small casters over a smooth receiver surface: every block is listed
    for every tile, but most of a tile's listed casters miss its bbox."""
    return casters(seed, n=1000, size=(0.05, 0.2)) + surface(seed + 100, h, w)


def skewed_lists(seed=7, h=64, w=128):
    """Most caster blocks clustered near light NDC (0.6, 0.6), the last
    ones scattered: the tiles whose receivers cover the cluster list
    several times the blocks the others do."""
    cluster = casters(seed, n=768, cap=768, size=(0.03, 0.1), area=(0.45, 0.75))
    scattered = casters(seed + 1, n=240, cap=256, size=(0.1, 0.5))
    return (np.concatenate([cluster[0], scattered[0]]), np.concatenate([cluster[1], scattered[1]])
            ) + surface(seed + 100, h, w)


# name -> builder of (clip, valid, lx, ly, ld)
CASES = {
    "orthographic": lambda: case({}, 64, 128, 0),
    "perspective": lambda: case({"persp": True}, 64, 128, 1),
    "w_crossing": lambda: case({"persp": True, "cross": 0.1}, 64, 128, 2),
    "ragged_grid": lambda: case({}, 40, 100, 3),
    "few_casters": lambda: case({"n": 5, "cap": 64}, 32, 64, 4),
    "no_casters": lambda: case({"n": 0, "cap": 64}, 16, 64, 5),
    "coherent_tiles": coherent_tiles,
    "skewed_lists": skewed_lists,
}
