"""Rasterizer test cases, built with the port alone (no jax, nothing of
the JAX package).

The cases are those of tests/test_raster_pallas.py, built with the port's
camera and meshes: box, sphere+torus, two-sided, near-crossing, empty,
multi-block, tile-aligned, crowded (the JAX kernel's bin-overflow case)
and random soups, hot-tile (the bench soup's heaviest tile in small) and
unsorted boxes (the debug-AABB view's soup in small).
Shared by the CPU tests, the card tests and chip_smoke.py; the
float64-reference gate is in torch_raster_gate.py.
"""

import numpy as np

from renderer_tpu_torch.mathx import Camera, camera_matrices, quat_from_axis_angle
from renderer_tpu_torch.ops.cull import compact_soup
from renderer_tpu_torch.ops.debug import aabb_soup
from renderer_tpu_torch.ops.geometry import prepare_frame_columns
from renderer_tpu_torch.scene import SceneBuilder, SceneLimits, primitives

def soup_from_meshes(meshes, vp, pad_to=256):
    clips = []
    for mesh in meshes:
        h = np.concatenate([mesh.positions, np.ones((len(mesh.positions), 1))], axis=1)
        clips.append((h @ np.asarray(vp).T)[mesh.indices])
    clip = np.concatenate(clips).astype(np.float32)
    t = len(clip)
    pad = (-t) % pad_to
    clip = np.concatenate([clip, np.zeros((pad, 3, 4), np.float32)])
    valid = np.concatenate([np.ones(t, bool), np.zeros(pad, bool)])
    return clip, valid


def camera_soup(meshes, position, rotation=None, near=0.1, far=20.0):
    cam = Camera.create(position, rotation, near=near, far=far, aspect=2.0, device="cpu")
    _, _, vp = camera_matrices(cam)
    return soup_from_meshes(meshes, vp.numpy())


def random_soup(seed, n=1024):
    """Mixed sizes, depths and windings; some w != 1, a few crossing w=0."""
    rng = np.random.default_rng(seed)
    center = rng.uniform(-1.2, 1.2, size=(n, 2)).astype(np.float32)
    size = rng.uniform(0.01, 0.5, size=(n, 1)).astype(np.float32)
    z = rng.uniform(0.05, 0.95, size=(n, 1)).astype(np.float32)
    offs = rng.uniform(-1.0, 1.0, size=(n, 3, 2)).astype(np.float32)
    tris = np.zeros((n, 3, 4), np.float32)
    tris[:, :, :2] = center[:, None, :] + size[:, None, :] * offs
    tris[:, :, 2] = z
    tris[:, :, 3] = 1.0
    pw = rng.uniform(0.5, 2.0, size=(n,)).astype(np.float32)
    tris[:, :, 3] *= pw[:, None]
    tris[:, :, :3] *= pw[:, None, None]
    cross = rng.random(n) < 0.02
    tris[cross, 0, 3] = -0.1  # one vertex behind the eye
    return tris, rng.random(n) < 0.9


def multi_block_soup():
    """700 small triangles over 3 record blocks after padding."""
    rng = np.random.default_rng(7)
    n = 700
    centers = rng.uniform(-0.9, 0.9, size=(n, 2))
    z = rng.uniform(0.1, 0.9, size=n)
    r = 0.05
    tris = np.array(
        [[[cx - r, cy - r, zk, 1], [cx + r, cy - r, zk, 1], [cx, cy + r, zk, 1]]
         for (cx, cy), zk in zip(centers, z)],
        np.float32,
    )
    pad = (-n) % 256
    return (np.concatenate([tris, np.zeros((pad, 3, 4), np.float32)]),
            np.concatenate([np.ones(n, bool), np.zeros(pad, bool)]))


def tile_aligned_soup(w=256, h=64):
    """Triangles whose bboxes land exactly on tile seams (the JAX kernel's
    32x128 seams and the port's 16x64 ones)."""
    px_tris = [
        [(100.0, 10.0), (128.0, 10.0), (114.0, 30.0)],
        [(128.0, 40.0), (156.0, 40.0), (142.0, 60.0)],
        [(40.0, 12.0), (70.0, 12.0), (55.0, 32.0)],
        [(128.0, 32.0), (150.0, 50.0), (120.0, 55.0)],
        [(120.0, 28.0), (140.0, 28.0), (130.0, 44.0)],
        [(60.0, 16.0), (64.0, 16.0), (62.0, 48.0)],
        [(192.0, 0.0), (200.0, 16.0), (186.0, 16.0)],
    ]
    tris = [[[px / w * 2.0 - 1.0, 1.0 - py / h * 2.0, 0.5, 1.0] for px, py in tri]
            for tri in px_tris]
    n = len(tris)
    pad = (-n) % 256
    return (np.concatenate([np.asarray(tris, np.float32), np.zeros((pad, 3, 4), np.float32)]),
            np.concatenate([np.ones(n, bool), np.zeros(pad, bool)]))


def crowded_soup():
    """Every triangle lands on the same corner tiles, so their bin lists
    span every block (the JAX kernel's bin-overflow case; the port's lists
    are uncapped)."""
    n = 4096
    rng = np.random.default_rng(3)
    base = rng.uniform(-0.9, -0.2, size=(n, 2)).astype(np.float32)
    z = rng.uniform(0.2, 0.8, size=n).astype(np.float32)
    tris = np.zeros((n, 3, 4), np.float32)
    tris[:, :, 3] = 1.0
    for k in range(3):
        tris[:, k, 0] = base[:, 0] + 0.02 * (k == 1)
        tris[:, k, 1] = base[:, 1] + 0.02 * (k == 2)
        tris[:, k, 2] = z
    return tris, np.ones(n, bool)


def hot_tile_soup(w=128, h=64):
    """The bench soup's hot tile in small: 706 triangles over 12 record
    blocks piled onto the 16x64 tile at columns 0..63, rows 16..31 (their
    padded bboxes reach into its neighbours), of both windings. Corners lie
    on a 4-pixel lattice (a quarter of them shifted by half a pixel), so
    the padded bboxes end on the pixel centres next to the 4-, 8- and
    32-pixel seams of the kernel's pixel regions, or exactly on a seam.
    Depths are spaced 1.3e-3 apart, five triangles repeat the five
    front-most ones exactly (the lower id wins the tie on every pixel), and
    one triangle crosses w = 0."""
    rng = np.random.default_rng(11)
    n = 700
    x0 = rng.integers(0, 15, size=n) * 4.0
    y0 = 16.0 + rng.integers(0, 4, size=n) * 4.0
    dx = np.minimum(rng.integers(1, 4, size=n) * 4.0, 64.0 - x0)
    dy = np.minimum(rng.integers(1, 3, size=n) * 4.0, 32.0 - y0)
    shift = np.where(rng.random(n) < 0.25, 0.5, 0.0)
    corners = np.stack([np.stack([x0 + shift, y0], 1), np.stack([x0 + dx - shift, y0], 1),
                        np.stack([x0 + shift, y0 + dy - shift], 1)], 1)  # (n, 3, 2) pixels
    flip = rng.random(n) < 0.5
    corners[flip] = corners[flip][:, ::-1]
    z = 0.05 + 0.9 * rng.permutation(n) / n
    # the w-crossing triangle in front of the pile, its second corner behind the eye
    corners = np.concatenate([corners, [[(4.0, 18.0), (60.0, 18.0), (4.0, 30.0)]]])
    z = np.append(z, 0.02)
    tris = np.zeros((n + 1, 3, 4), np.float32)
    tris[:, :, 0] = corners[:, :, 0] / w * 2.0 - 1.0
    tris[:, :, 1] = 1.0 - corners[:, :, 1] / h * 2.0
    tris[:, :, 2] = z[:, None]
    tris[:, :, 3] = 1.0
    tris[n, 1, 3] = -0.1
    front = np.argsort(z[:n])[:5]
    tris = np.concatenate([tris[:n], tris[front], tris[n:]])
    t = len(tris)
    pad = (-t) % 256
    return (np.concatenate([tris, np.zeros((pad, 3, 4), np.float32)]),
            np.concatenate([np.ones(t, bool), np.zeros(pad, bool)]))


def unsorted_box_soup(n=150, seed=5):
    """The debug-AABB view's soup in small: the boxes (12 triangles each) of
    a ground plane and n boxes scattered before a camera, as the view
    builds them, compacted in instance order and not sorted, so that each
    64-triangle block spans the image. The ground's box is flat (its side
    faces degenerate) and reaches behind the eye."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder(SceneLimits(max_vertices=1024, max_triangles=1024, max_meshes=4,
                                 max_instances=256, max_materials=2, max_lights=1,
                                 max_textures=1))
    ground, box = b.add_mesh(primitives.plane(size=60.0)), b.add_mesh(primitives.box())
    b.add_instance(ground, translation=(0.0, -1.0, 0.0))
    pos = rng.uniform(-12.0, 12.0, size=(n, 2))
    for (x, z), s, h in zip(pos, rng.uniform(0.3, 2.0, n), rng.uniform(-0.5, 2.0, n)):
        b.add_instance(box, translation=(x, h, z), scale=float(s))
    b.add_light(position=(0.0, 5.0, 0.0))
    scene = b.build(device="cpu")
    cam = Camera.create([2.0, 3.0, 14.0], quat_from_axis_angle([1.0, 0.0, 0.0], -0.2, device="cpu"),
                        fov_y=0.9, aspect=4.0, near=0.1, far=60.0, device="cpu")
    prep = prepare_frame_columns(scene, cam)
    soup = compact_soup(aabb_soup(scene, prep.visible, prep.clip_mats, prep.model, 2048))
    return soup.clip.numpy(), soup.valid.numpy()


HOT_TILE = 2  # the tile of hot_tile_soup's pile (tile row 1, column 0)

# name -> (soup builder, width, height, cull_backface)
CASES = {
    "box": (lambda: camera_soup([primitives.box()], [1.2, 1.0, 2.5]), 128, 64, True),
    "sphere_torus": (lambda: camera_soup(
        [primitives.uv_sphere(rings=10, sectors=14), primitives.torus()], [0.0, 0.4, 2.4]),
        128, 64, True),
    "two_sided": (lambda: camera_soup(
        [primitives.torus()], [0.0, 1.2, 2.0],
        rotation=quat_from_axis_angle([1.0, 0.0, 0.0], -0.5, device="cpu")),
        128, 64, False),
    "near_crossing": (lambda: camera_soup(
        [primitives.box(size=4.0)], [0.05, 0.0, 0.1], near=0.05, far=50.0), 128, 64, False),
    "empty": (lambda: (np.zeros((256, 3, 4), np.float32), np.zeros(256, bool)), 128, 32, True),
    "multi_block": (multi_block_soup, 128, 64, True),
    "tile_aligned": (tile_aligned_soup, 256, 64, False),
    "crowded": (crowded_soup, 128, 64, False),
    "hot_tile": (hot_tile_soup, 128, 64, False),
    "unsorted_boxes": (unsorted_box_soup, 256, 64, True),
    "random_cull": (lambda: random_soup(100), 256, 64, True),
    "random_two_sided": (lambda: random_soup(101), 256, 64, False),
}
