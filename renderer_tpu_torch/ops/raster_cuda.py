"""Tile rasterizer (``renderer_tpu.ops.raster_pallas``): triangle setup and
binning in PyTorch, the per-pixel loop in a hand-written CUDA kernel
(``csrc/raster.cu``), and that loop's plain PyTorch version.

Semantics are ``renderer_tpu/ops/raster_spec.py``: clipless homogeneous
edge functions, the top-left fill rule, per-pixel w > 0 and 0 <= z <= 1,
a strict depth test in which the lower triangle id wins a tie.

``rasterize_cuda`` takes the plain version for CPU tensors and the kernel
for CUDA tensors; nothing falls back from one to the other. The kernel and
the plain version visit triangles in the same order and round every
operation alike, so they agree bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from renderer_tpu_torch.ops.cuda_build import check_inputs, library
from renderer_tpu_torch.ops.raster_spec import DEPTH_CLEAR, FRONT_DET_SIGN, NO_TRIANGLE

TILE_H = 16
TILE_W = 64
BLOCK = 64  # triangles per record block and per 64-bit tile mask word
ROWS = 32   # floats per triangle record
R_E = 0     # 0..8 oriented edge coefficients (e0 a,b,c, e1, e2)
R_Z = 9     # 9..11 z_clip per corner
R_W = 12    # 12..14 w_clip per corner
R_BB = 15   # 15..18 bbox xmin, xmax, ymin, ymax in pixels (+-inf if dead)
R_TL = 19   # 19..21 top-left flag per edge (1.0 / 0.0)

LIBRARY = library("raster.cu")


class VisibilityBuffer(NamedTuple):
    depth: torch.Tensor   # (H, W) f32, DEPTH_CLEAR where empty
    tri_id: torch.Tensor  # (H, W) i32, NO_TRIANGLE where empty
    bary: torch.Tensor    # (3, H, W) f32, zero where empty


def setup_tri_data(clip, valid, width: int, height: int, cull_backface: bool):
    """Per-triangle raster records (T, ROWS) from clip corners (T, 3, 4).

    Returns (rec, (xmin, xmax, ymin, ymax, ok), simple). ``height`` is the
    full image height. A "simple" triangle (all corners in front, z in
    [0, w] corner-wise) needs no per-pixel w or z test."""
    t_cap = clip.shape[0]
    ct = clip.reshape(t_cap, 12).T.contiguous()
    x = [ct[4 * c] for c in range(3)]
    y = [ct[4 * c + 1] for c in range(3)]
    zs = [ct[4 * c + 2] for c in range(3)]
    ws = [ct[4 * c + 3] for c in range(3)]
    ux = [(x[c] + ws[c]) * (0.5 * width) for c in range(3)]
    uy = [(ws[c] - y[c]) * (0.5 * height) for c in range(3)]
    uz = ws

    def cross(a, b):  # adjugate row: cross of the other two corners
        return (
            uy[a] * uz[b] - uz[a] * uy[b],
            uz[a] * ux[b] - ux[a] * uz[b],
            ux[a] * uy[b] - uy[a] * ux[b],
        )

    det = (
        ux[0] * (uy[1] * uz[2] - uy[2] * uz[1])
        - ux[1] * (uy[0] * uz[2] - uy[2] * uz[0])
        + ux[2] * (uy[0] * uz[1] - uy[1] * uz[0])
    )
    if cull_backface:
        sgn = FRONT_DET_SIGN
        ok = valid & (det * FRONT_DET_SIGN > 0)
    else:
        sgn = torch.sign(det)
        ok = valid & (det != 0)
    adj_rows = [[comp * sgn for comp in cross(a, b)] for a, b in ((1, 2), (2, 0), (0, 1))]

    all_front = (ws[0] > 1e-9) & (ws[1] > 1e-9) & (ws[2] > 1e-9)
    safe_w = [torch.where(w.abs() > 1e-9, w, 1e-9) for w in ws]
    px = [ux[c] / safe_w[c] for c in range(3)]
    py = [uy[c] / safe_w[c] for c in range(3)]

    def min3(v):
        return torch.minimum(torch.minimum(v[0], v[1]), v[2])

    def max3(v):
        return torch.maximum(torch.maximum(v[0], v[1]), v[2])

    xmin = torch.where(all_front, min3(px) - 0.5, 0.0)
    xmax = torch.where(all_front, max3(px) + 0.5, float(width))
    ymin = torch.where(all_front, min3(py) - 0.5, 0.0)
    ymax = torch.where(all_front, max3(py) + 0.5, float(height))
    on_screen = (xmax >= 0) & (xmin <= width) & (ymax >= 0) & (ymin <= height)
    ok = ok & on_screen
    top_left = [((row[0] > 0) | ((row[0] == 0) & (row[1] > 0))).float() for row in adj_rows]
    inf = float("inf")
    cols = (
        [comp for row in adj_rows for comp in row] + zs + ws
        + [torch.where(ok, xmin, inf), torch.where(ok, xmax, -inf),
           torch.where(ok, ymin, inf), torch.where(ok, ymax, -inf)]
        + top_left
    )
    rec = torch.zeros((t_cap, ROWS), dtype=torch.float32, device=clip.device)
    rec[:, : len(cols)] = torch.stack(cols, dim=1)
    z_in = (
        (zs[0] >= 0) & (zs[1] >= 0) & (zs[2] >= 0)
        & (zs[0] <= ws[0]) & (zs[1] <= ws[1]) & (zs[2] <= ws[2])
    )
    return rec, (xmin, xmax, ymin, ymax, ok), ok & all_front & z_in


def _pack_bits(b: torch.Tensor) -> torch.Tensor:
    """(R, T) bool -> (R, T // 64) int64 words, bit k = column 64*j + k."""
    r, t = b.shape
    shifts = torch.arange(BLOCK, dtype=torch.int64, device=b.device)
    return (b.reshape(r, t // BLOCK, BLOCK).long() << shifts).sum(-1)


def bin_tri_masks(bbox_ok, width: int, height: int, y0: int = 0) -> torch.Tensor:
    """(n_tiles, n_blocks) int64: bit k of [tile, b] is set iff triangle
    64b+k takes part and its bbox tile-interval contains the tile.

    The tile set of a triangle is a rectangle of tile coordinates, so the
    mask word is the AND of a row word and a column word."""
    xmin, xmax, ymin, ymax, ok = bbox_ok
    dev = ok.device
    n_ty, n_tx = height // TILE_H, width // TILE_W
    tx = torch.arange(n_tx, dtype=torch.float32, device=dev)[:, None]
    ty = torch.arange(n_ty, dtype=torch.float32, device=dev)[:, None]
    ox = ((torch.floor(xmin * (1.0 / TILE_W)) <= tx)
          & (tx <= torch.floor(xmax * (1.0 / TILE_W))) & ok)
    oy = ((torch.floor((ymin - y0) * (1.0 / TILE_H)) <= ty)
          & (ty <= torch.floor((ymax - y0) * (1.0 / TILE_H))))
    words_x, words_y = _pack_bits(ox), _pack_bits(oy)
    return (words_y[:, None, :] & words_x[None, :, :]).reshape(n_ty * n_tx, -1)


def bin_blocks_from_masks(masks: torch.Tensor):
    """Per tile, the ascending list of blocks with a nonzero mask word.
    Returns (block_list (n_tiles, n_blocks) i32, block_count (n_tiles,) i32);
    entries at or past a tile's count are unused."""
    n_tiles, n_blocks = masks.shape
    nz = masks != 0
    dest = torch.where(nz, torch.cumsum(nz, dim=1) - 1, n_blocks)
    ids = torch.arange(n_blocks, dtype=torch.int32, device=masks.device).expand(n_tiles, -1)
    lists = torch.zeros((n_tiles, n_blocks + 1), dtype=torch.int32, device=masks.device)
    lists.scatter_(1, dest, ids)  # column n_blocks collects the empty entries
    return lists[:, :n_blocks].contiguous(), nz.sum(dim=1, dtype=torch.int32)


def raster_tiles_plain(rec, masks, block_list, block_count, block_simple,
                       width: int, height: int, y0: int, with_bary: bool):
    """The kernel's semantics in PyTorch, vectorized across tiles: a loop
    over bin-list positions x the 64 triangles of a block, each step one
    tensor op per quantity over every tile's pixels, so each pixel sees the
    triangles in the kernel's order. Returns (depth, tri_id, b0, b1)."""
    dev = rec.device
    n_ty, n_tx = height // TILE_H, width // TILE_W
    n_tiles = n_ty * n_tx
    tiles = torch.arange(n_tiles, device=dev)
    tx0 = ((tiles % n_tx) * TILE_W).float()[:, None, None]
    ty0 = ((tiles // n_tx) * TILE_H + y0).float()[:, None, None]
    px = torch.arange(TILE_W, dtype=torch.float32, device=dev)[None, None, :] + tx0 + 0.5
    py = torch.arange(TILE_H, dtype=torch.float32, device=dev)[None, :, None] + ty0 + 0.5
    shape = (n_tiles, TILE_H, TILE_W)
    znum = torch.full(shape, DEPTH_CLEAR, dtype=torch.float32, device=dev)
    wden = torch.ones(shape, dtype=torch.float32, device=dev)
    tid = torch.full(shape, NO_TRIANGLE, dtype=torch.int32, device=dev)
    lam0_w = torch.zeros(shape, dtype=torch.float32, device=dev)
    lam1_w = torch.zeros(shape, dtype=torch.float32, device=dev)
    lsum_w = torch.ones(shape, dtype=torch.float32, device=dev)
    shifts = torch.arange(BLOCK, dtype=torch.int64, device=dev)
    n_steps = int(block_count.max()) if n_tiles else 0
    for i in range(n_steps):
        live = i < block_count
        blk = torch.where(live, block_list[:, i], 0).long()
        words = torch.where(live, masks[tiles, blk], 0)
        bits = ((words[:, None] >> shifts) & 1) != 0  # (n_tiles, 64)
        simple = (block_simple[blk] != 0)[:, None, None]
        for k in torch.nonzero(bits.any(dim=0)).flatten().tolist():
            tri = blk * BLOCK + k
            r = rec[tri][:, :, None, None]  # (n_tiles, ROWS, 1, 1)
            lam = [r[:, R_E + 3 * e] * px + r[:, R_E + 3 * e + 1] * py + r[:, R_E + 3 * e + 2]
                   for e in range(3)]
            w_i = lam[0] * r[:, R_W] + lam[1] * r[:, R_W + 1] + lam[2] * r[:, R_W + 2]
            z_num = lam[0] * r[:, R_Z] + lam[1] * r[:, R_Z + 1] + lam[2] * r[:, R_Z + 2]
            cov = bits[:, k, None, None]
            for e in range(3):
                cov = cov & ((lam[e] > 0) | ((lam[e] == 0) & (r[:, R_TL + e] != 0)))
            cov = (cov & (px >= r[:, R_BB]) & (px <= r[:, R_BB + 1])
                   & (py >= r[:, R_BB + 2]) & (py <= r[:, R_BB + 3]))
            cov = cov & (simple | ((w_i > 0) & (z_num >= 0.0) & (z_num <= w_i)))
            closer = cov & (z_num * wden < znum * w_i)
            znum = torch.where(closer, z_num, znum)
            wden = torch.where(closer, w_i, wden)
            tid = torch.where(closer, tri.to(torch.int32)[:, None, None], tid)
            if with_bary:
                lam0_w = torch.where(closer, lam[0], lam0_w)
                lam1_w = torch.where(closer, lam[1], lam1_w)
                lsum_w = torch.where(closer, lam[0] + lam[1] + lam[2], lsum_w)
    depth = znum / wden
    if with_bary:
        inv = 1.0 / torch.where(lsum_w != 0.0, lsum_w, 1.0)
        b0, b1 = lam0_w * inv, lam1_w * inv
    else:
        b0, b1 = torch.zeros_like(depth), torch.zeros_like(depth)

    def image(a):  # (n_tiles, TILE_H, TILE_W) -> (H, W)
        return a.reshape(n_ty, n_tx, TILE_H, TILE_W).permute(0, 2, 1, 3).reshape(height, width)

    return image(depth), image(tid), image(b0), image(b1)


RASTER_TILES = LIBRARY.kernel("rtt_raster_tiles",
                              [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 5)


def raster_kernel(rec, masks, block_list, block_count, block_simple,
                  width: int, height: int, y0: int, with_bary: bool):
    """Same arguments and results as ``raster_tiles_plain``; CUDA tensors
    only. ``RASTER_TILES.launches`` counts the launches."""
    n_ty, n_tx = height // TILE_H, width // TILE_W
    n_blocks = rec.shape[0] // BLOCK
    index = check_inputs(
        "raster",
        (rec, torch.float32, (n_blocks * BLOCK, ROWS)),
        (masks, torch.int64, (n_ty * n_tx, n_blocks)),
        (block_list, torch.int32, (n_ty * n_tx, n_blocks)),
        (block_count, torch.int32, (n_ty * n_tx,)),
        (block_simple, torch.int32, (n_blocks,)),
    )
    if rec.data_ptr() % 16:
        raise ValueError("raster kernel input: the records must be 16-byte aligned")
    depth = torch.empty((height, width), dtype=torch.float32, device=rec.device)
    tri_id = torch.empty((height, width), dtype=torch.int32, device=rec.device)
    b0 = torch.empty_like(depth)
    b1 = torch.empty_like(depth)
    bb = torch.empty((n_blocks * BLOCK, 4), dtype=torch.float32, device=rec.device)  # bbox side copy
    RASTER_TILES.launch(index, rec.data_ptr(), masks.data_ptr(), block_list.data_ptr(),
                        block_count.data_ptr(), block_simple.data_ptr(), n_ty * n_tx, n_blocks,
                        n_tx, int(y0), width, int(bool(with_bary)), depth.data_ptr(),
                        tri_id.data_ptr(), b0.data_ptr(), b1.data_ptr(), bb.data_ptr())
    return depth, tri_id, b0, b1


def raster_inputs(clip, valid, width: int, height: int, cull_backface: bool = True,
                  y0: int = 0, full_height: int = None) -> tuple:
    """Setup + binning: the arguments of the per-pixel loop, up to
    ``with_bary``: (rec, masks, block_list, block_count, block_simple,
    width, height, y0)."""
    t_cap = clip.shape[0]
    if t_cap % BLOCK or width % TILE_W or height % TILE_H:
        raise ValueError(
            f"raster needs T % {BLOCK} == 0, width % {TILE_W} == 0, height % "
            f"{TILE_H} == 0; got T={t_cap}, {width}x{height}"
        )
    rec, bbox_ok, simple = setup_tri_data(
        clip, valid, width, full_height or height, cull_backface
    )
    masks = bin_tri_masks(bbox_ok, width, height, y0)
    block_list, block_count = bin_blocks_from_masks(masks)
    # a block takes the simple path when all its live triangles are simple
    block_simple = torch.all((simple | ~bbox_ok[4]).reshape(-1, BLOCK), dim=1).to(torch.int32)
    return rec, masks, block_list, block_count, block_simple, width, height, y0


def rasterize_cuda(clip, valid, width: int, height: int, cull_backface: bool = True,
                   with_bary: bool = True, y0: int = 0,
                   full_height: int = None) -> VisibilityBuffer:
    """Rasterize (T, 3, 4) clip corners into a (height, width) visibility
    buffer: rows [y0, y0 + height) of a full_height image. CUDA tensors go
    through the kernel, CPU tensors through the plain version."""
    args = raster_inputs(clip, valid, width, height, cull_backface, y0, full_height)
    if clip.device.type == "cuda":
        depth, tri_id, b0, b1 = raster_kernel(*args, with_bary)
    elif clip.device.type == "cpu":
        depth, tri_id, b0, b1 = raster_tiles_plain(*args, with_bary)
    else:
        raise ValueError(f"no rasterizer for device {clip.device}")
    bary = torch.stack([b0, b1, 1.0 - b0 - b1], dim=0)
    bary = torch.where((tri_id != NO_TRIANGLE)[None], bary, 0.0)
    return VisibilityBuffer(depth=depth, tri_id=tri_id, bary=bary)
