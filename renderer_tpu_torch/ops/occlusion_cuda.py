"""Light-space occlusion walk (``renderer_tpu.ops.rt_grid._occlusion_kernel``):
the hand-written CUDA kernel (``csrc/occlusion.cu``) and its plain PyTorch
version.

Inputs, as ``ops/rt_grid.occlusion_inputs`` builds them: caster records
(T, REC) f32, per screen tile the ascending list of caster blocks binned to
it (n_tiles, n_blocks) i32 with its length (n_tiles,) i32, each tile's
receiver bbox in light NDC (n_tiles, 4) f32 (xmin, xmax, ymin, ymax), and
the receivers' light-space x, y and depth as (H, W) f32 planes that are
16x64 tile multiples. The result is the (H, W) plane, 1 lit and 0
occluded; receivers with a non-finite depth (ld = +inf: background) are
skipped and stay lit. The kernel and the plain version test the same
(receiver, caster) pairs and round every operation alike, so they agree
bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from renderer_tpu_torch.ops.cuda_build import check_inputs, library
from renderer_tpu_torch.ops.raster_cuda import BLOCK, TILE_H, TILE_W

REC = 20   # floats per caster record
O_E = 0    # 0..8 sign-normalized edge coefficients (inside => all lam >= 0)
O_Z = 9    # 9..11 z_clip per corner (depth = z_num / w_den)
O_W = 12   # 12..14 w_clip per corner
O_BB = 15  # 15..18 light NDC bbox xmin, xmax, ymin, ymax
O_OK = 19  # 1.0 live caster, 0.0 dead

SEGMENT_BLOCKS = 32  # caster blocks per work item (tile, segment) of the kernel
SEGMENT_MAX = 64     # the most the kernel takes (csrc/occlusion.cu SEG_MAX)

LIBRARY = library("occlusion.cu")
_PTR, _I32 = ctypes.c_void_p, ctypes.c_int
OCCLUSION_TILES = LIBRARY.kernel("rtt_occlusion_tiles",
                                 [_PTR] * 7 + [_I32] * 5 + [_PTR, _PTR, ctypes.c_size_t])
PLAIN_CHUNK = 1 << 24  # (tile, caster, receiver) triples per plain-version step


def _tile_rows(a: torch.Tensor) -> torch.Tensor:
    """(H, W) -> (n_tiles, TILE_H * TILE_W), tiles in row-major order."""
    h, w = a.shape
    return (a.reshape(h // TILE_H, TILE_H, w // TILE_W, TILE_W).permute(0, 2, 1, 3)
            .reshape(-1, TILE_H * TILE_W))


def caster_hits(r: torch.Tensor, bb: torch.Tensor) -> torch.Tensor:
    """(c, BLOCK) bool: the live casters of records r (c, BLOCK, REC) whose
    bbox overlaps each tile's receiver bbox bb (c, 4)."""
    return ((r[:, :, O_OK] > 0.5) & (r[:, :, O_BB] <= bb[:, 1:2]) & (r[:, :, O_BB + 1] >= bb[:, 0:1])
            & (r[:, :, O_BB + 2] <= bb[:, 3:4]) & (r[:, :, O_BB + 3] >= bb[:, 2:3]))


def occlusion_tiles_plain(rec, block_list, block_count, tile_bbox, lx, ly, ld):
    """The kernel's semantics in PyTorch: a loop over bin-list positions,
    each step one tensor op per quantity over (tiles, the 64 casters of
    the block, the tile's receivers), in chunks of tiles. The result is an
    OR over casters, so the visiting order does not matter."""
    h, w = lx.shape
    dev = lx.device
    rx, ry, rd = _tile_rows(lx), _tile_rows(ly), _tile_rows(ld)
    n_tiles = rx.shape[0]
    lit = torch.ones(rx.shape, dtype=torch.bool, device=dev)
    recb = rec.reshape(-1, BLOCK, REC)
    chunk = max(1, PLAIN_CHUNK // (BLOCK * TILE_H * TILE_W))
    n_steps = int(block_count.max()) if n_tiles else 0
    for i in range(n_steps):
        tiles = torch.nonzero(block_count > i).flatten()
        for c0 in range(0, tiles.numel(), chunk):
            tl = tiles[c0:c0 + chunk]
            r = recb[block_list[tl, i].long()]  # (c, BLOCK, REC)
            hit = caster_hits(r, tile_bbox[tl])

            def col(k):
                return r[:, :, k, None]  # (c, BLOCK, 1)

            x, y, d = rx[tl, None, :], ry[tl, None, :], rd[tl, None, :]  # (c, 1, P)
            lam = [col(O_E + 3 * e) * x + col(O_E + 3 * e + 1) * y + col(O_E + 3 * e + 2)
                   for e in range(3)]
            z_num = lam[0] * col(O_Z) + lam[1] * col(O_Z + 1) + lam[2] * col(O_Z + 2)
            w_den = lam[0] * col(O_W) + lam[1] * col(O_W + 1) + lam[2] * col(O_W + 2)
            cov = (hit[:, :, None] & torch.isfinite(d) & (lam[0] >= 0) & (lam[1] >= 0)
                   & (lam[2] >= 0) & (w_den > 0) & (z_num < d * w_den))
            lit[tl] &= ~cov.any(dim=1)
    n_ty, n_tx = h // TILE_H, w // TILE_W
    return (lit.float().reshape(n_ty, n_tx, TILE_H, TILE_W).permute(0, 2, 1, 3)
            .reshape(h, w))


def segments(block_count: torch.Tensor, segment_blocks: int) -> torch.Tensor:
    """Work items per tile: its bin list cut into segments of
    ``segment_blocks`` blocks."""
    return (block_count + segment_blocks - 1) // segment_blocks


def scratch_bytes(n_tiles: int, n_blocks: int, segment_blocks: int) -> int:
    """Bytes of the kernel's device scratch, laid out as
    ``rtt_occlusion_tiles`` carves it: the work counter and the item count
    (16 B), a bbox side copy per caster slot (16 B), the tile order (4 B a
    tile, rounded up to an even count) and the work items (8 B each, at most
    ceil(n_blocks / segment_blocks) per tile)."""
    n_seg = -(-n_blocks // segment_blocks)
    return 16 + 16 * n_blocks * BLOCK + 4 * (n_tiles + n_tiles % 2) + 8 * n_tiles * n_seg


def occlusion_kernel(rec, block_list, block_count, tile_bbox, lx, ly, ld,
                     segment_blocks: int = SEGMENT_BLOCKS):
    """Same arguments and result as ``occlusion_tiles_plain``; CUDA tensors
    only. Each tile's bin list is walked in segments of ``segment_blocks``
    blocks (1..SEGMENT_MAX); the plane does not depend on it.
    ``OCCLUSION_TILES.launches`` counts the launches."""
    if not 1 <= segment_blocks <= SEGMENT_MAX:
        raise ValueError(f"occlusion kernel: segment_blocks {segment_blocks} not in 1..{SEGMENT_MAX}")
    h, w = lx.shape
    if h % TILE_H or w % TILE_W:
        raise ValueError(f"occlusion kernel: receiver planes {h}x{w} are not 16x64 tile multiples")
    n_ty, n_tx = h // TILE_H, w // TILE_W
    n_tiles, n_blocks = n_ty * n_tx, rec.shape[0] // BLOCK
    index = check_inputs(
        "occlusion",
        (rec, torch.float32, (n_blocks * BLOCK, REC)),
        (block_list, torch.int32, (n_tiles, n_blocks)),
        (block_count, torch.int32, (n_tiles,)),
        (tile_bbox, torch.float32, (n_tiles, 4)),
        (lx, torch.float32, (h, w)),
        (ly, torch.float32, (h, w)),
        (ld, torch.float32, (h, w)),
    )
    if rec.data_ptr() % 16:
        raise ValueError("occlusion kernel input: the records must be 16-byte aligned")
    occ = torch.empty((h, w), dtype=torch.float32, device=rec.device)
    n_scratch = scratch_bytes(n_tiles, n_blocks, segment_blocks)
    scratch = torch.empty((n_scratch,), dtype=torch.uint8, device=rec.device)
    OCCLUSION_TILES.launch(index, rec.data_ptr(), block_list.data_ptr(),
                           block_count.data_ptr(), tile_bbox.data_ptr(), lx.data_ptr(),
                           ly.data_ptr(), ld.data_ptr(), n_tiles, n_blocks, n_tx, w,
                           segment_blocks, occ.data_ptr(), scratch.data_ptr(), n_scratch)
    return occ
