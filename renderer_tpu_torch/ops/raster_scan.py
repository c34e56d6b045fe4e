"""The independent scan rasterizer (``renderer_tpu.ops.raster_jax``'s
``rasterize``): its per-triangle setup in PyTorch, its block loop as a CUDA
kernel (``csrc/scan_raster.cu``) and that loop's plain PyTorch version.

It shares no code with kernel 1 (``ops/raster_cuda.py``) or its plain
version: no records, no binning, no tiles. Every triangle is tested
against every pixel, block after block, with a running (depth, id,
barycentrics) reduction, following ``ops/raster_spec.py``'s rules
directly. The plain configuration (``PipelineConfig(tile_raster=False)``)
renders its frames and its shadow atlas through it, and the reference view
renders through it, so that a fault of the main raster shows as a
difference.

Like the JAX package, the loop walks only the blocks below
ceil(count / tri_block) when given the soup's count (whole blocks: a live
triangle past the count in the last walked block is still rasterized).
On the card the kernel reads the count on the device, so a frame never
waits for the card. On the CPU the plain version reads it on the host (a
free read there) and also skips blocks without a live triangle and crops
each block to the pixels its live bboxes reach: a pixel outside every
bbox of a block is covered by none of its triangles, so the output is the
same either way. Sums are multiply-adds taken left to right.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from renderer_tpu_torch.ops.cuda_build import check_inputs, library
from renderer_tpu_torch.ops.geometry import adjugate3, det3, pixel_homogeneous
from renderer_tpu_torch.ops.raster_cuda import VisibilityBuffer
from renderer_tpu_torch.ops.raster_spec import DEPTH_CLEAR, FRONT_DET_SIGN, NO_TRIANGLE

# (triangle, edge, pixel) elements of one step's temporaries in the plain version
STEP_ELEMENTS = 1 << 22

LIBRARY = library("scan_raster.cu")
_PTR, _I32 = ctypes.c_void_p, ctypes.c_int
SCAN_RASTER = LIBRARY.kernel("rtt_scan_raster",
                             [_PTR] * 7 + [_I32] * 5 + [_PTR, ctypes.c_longlong] + [_PTR] * 3)


class ScanInputs(NamedTuple):
    """The per-triangle setup the block loop reads."""

    adj: torch.Tensor       # (T, 3 edges, 3) f32 edge coefficients, oriented inside-positive
    bb: torch.Tensor        # (T, 4) f32 screen bbox: xmin, xmax, ymin, ymax
    top_left: torch.Tensor  # (T, 3) bool: the edge is a top or a left one
    tri_ok: torch.Tensor    # (T,) bool: valid, and front-facing under the cull
    zs: torch.Tensor        # (T, 3) f32 clip z per corner
    ws: torch.Tensor        # (T, 3) f32 clip w per corner


def scan_inputs(clip: torch.Tensor, valid: torch.Tensor, width: int, height: int,
                cull_backface: bool = True) -> ScanInputs:
    """The setup of a (T, 3, 4) clip-space soup with its (T,) valid mask."""
    u = pixel_homogeneous(clip, width, height)  # (T, corner, 3)
    m = u.transpose(-1, -2)  # columns are corners
    adj_raw = adjugate3(m)
    det = det3(m)
    if cull_backface:
        adj = adj_raw * FRONT_DET_SIGN
        tri_ok = valid & (det * FRONT_DET_SIGN > 0)
    else:
        adj = adj_raw * torch.sign(det)[:, None, None]
        tri_ok = valid & (det != 0)
    zs, ws = clip[..., 2].contiguous(), clip[..., 3].contiguous()
    # the screen bbox clamps the near-degenerate coverage of edge-on slivers;
    # a triangle reaching w <= 0 gets the whole screen
    all_front = (ws > 1e-9).all(dim=-1)
    safe_w = torch.where(ws.abs() > 1e-9, ws, 1e-9)
    px, py = u[..., 0] / safe_w, u[..., 1] / safe_w
    bb = torch.stack([
        torch.where(all_front, px.min(dim=-1).values - 0.5, 0.0),
        torch.where(all_front, px.max(dim=-1).values + 0.5, float(width)),
        torch.where(all_front, py.min(dim=-1).values - 0.5, 0.0),
        torch.where(all_front, py.max(dim=-1).values + 0.5, float(height)),
    ], dim=-1)  # (T, 4)
    # the top-left rule per edge: a pixel centre exactly on an edge belongs
    # to the triangle when the edge is a top or a left one
    top_left = (adj[..., 0] > 0) | ((adj[..., 0] == 0) & (adj[..., 1] > 0))  # (T, 3)
    return ScanInputs(adj.contiguous(), bb, top_left, tri_ok, zs, ws)


def live_blocks(count, t_cap: int, tri_block: int) -> int:
    """The blocks a count-bounded loop over ``t_cap`` triangles walks:
    ceil(count / tri_block), at most all of them; all of them without a
    count. Reads the count on the host."""
    n_blocks = t_cap // tri_block
    if count is None:
        return n_blocks
    return min(-(-max(int(count), 0) // tri_block), n_blocks)


def _windows(bb, tri_ok, tri_block: int, n_live: int, width: int, height: int) -> list:
    """The plain walk as (x0, x1, y0, y1, block start) windows, each cut
    into row bands within the step budget: per block below ``n_live``
    holding a live triangle, the pixels whose centres its live bboxes reach
    (one pixel of margin). Reads the bboxes on the host."""
    inf = math.inf
    n = n_live * tri_block
    ok = tri_ok[:n, None]
    # a NaN bound covers nothing (every comparison with it is false)
    lo = torch.where(ok, torch.nan_to_num(bb[:n, 0::2], nan=inf), inf)
    hi = torch.where(ok, torch.nan_to_num(bb[:n, 1::2], nan=-inf), -inf)
    lo = lo.reshape(-1, tri_block, 2).amin(dim=1).tolist()
    hi = hi.reshape(-1, tri_block, 2).amax(dim=1).tolist()
    out = []
    for k, ((xl, yl), (xh, yh)) in enumerate(zip(lo, hi)):
        if xl > xh or yl > yh:
            continue
        x0, y0 = (max(0, math.floor(max(v, -1.0) - 0.5)) for v in (xl, yl))
        x1 = min(width, math.floor(min(xh, width + 1.0) - 0.5) + 2)
        y1 = min(height, math.floor(min(yh, height + 1.0) - 0.5) + 2)
        if x0 < x1 and y0 < y1:
            rows = max(1, STEP_ELEMENTS // (3 * tri_block * (x1 - x0)))
            out += [(x0, x1, r0, min(r0 + rows, y1), k * tri_block) for r0 in range(y0, y1, rows)]
    return out


def scan_raster_plain(inp: ScanInputs, count, width: int, height: int, tri_block: int = 128,
                      with_bary: bool = True) -> VisibilityBuffer:
    """The block loop in PyTorch, on any device; reads the count and the
    bboxes on the host. ``count``: the soup's count (a 0-dim tensor or an
    int) or None for every block."""
    adj, bb, top_left, tri_ok, zs, ws = inp
    dev = adj.device
    n_live = live_blocks(count, adj.shape[0], tri_block)
    depth_out = torch.full((height, width), DEPTH_CLEAR, dtype=torch.float32, device=dev)
    id_out = torch.full((height, width), NO_TRIANGLE, dtype=torch.int32, device=dev)
    bary_out = torch.zeros((3, height, width), dtype=torch.float32, device=dev)
    for x0, x1, y0, y1, b0 in _windows(bb, tri_ok, tri_block, n_live, width, height):
        w_, p = x1 - x0, (y1 - y0) * (x1 - x0)
        qx = (torch.arange(x0, x1, dtype=torch.float32, device=dev) + 0.5).repeat(y1 - y0)
        qy = (torch.arange(y0, y1, dtype=torch.float32, device=dev) + 0.5).repeat_interleave(w_)
        depth = depth_out[y0:y1, x0:x1].reshape(p)
        sl = slice(b0, b0 + tri_block)
        a = adj[sl]  # (B, 3 edges, 3)
        lam = a[:, :, 0, None] * qx + a[:, :, 1, None] * qy + a[:, :, 2, None]  # (B, 3, P)
        inside = (lam > 0) | ((lam == 0) & top_left[sl][:, :, None])
        box = bb[sl]
        covered = (inside.all(dim=1) & (qx >= box[:, 0:1]) & (qx <= box[:, 1:2])
                   & (qy >= box[:, 2:3]) & (qy <= box[:, 3:4]))
        wb, zb = ws[sl], zs[sl]
        w_i = lam[:, 0] * wb[:, 0, None] + lam[:, 1] * wb[:, 1, None] + lam[:, 2] * wb[:, 2, None]
        z_num = lam[:, 0] * zb[:, 0, None] + lam[:, 1] * zb[:, 1, None] + lam[:, 2] * zb[:, 2, None]
        z = z_num / torch.where(w_i != 0, w_i, 1.0)
        covered &= (w_i > 0) & (z >= 0.0) & (z <= 1.0) & tri_ok[sl][:, None]
        z_masked = torch.where(covered, z, torch.inf)
        win = torch.argmin(z_masked, dim=0)  # the lowest id on ties
        win_z = z_masked.gather(0, win[None])[0]
        closer = win_z < depth
        depth_out[y0:y1, x0:x1] = torch.where(closer, win_z, depth).reshape(y1 - y0, w_)
        ids = id_out[y0:y1, x0:x1].reshape(p)
        id_out[y0:y1, x0:x1] = torch.where(closer, (win + b0).to(torch.int32),
                                           ids).reshape(y1 - y0, w_)
        if with_bary:
            win_lam = lam.gather(0, win[None, None].expand(1, 3, p))[0]  # (3, P)
            lam_sum = win_lam[0] + win_lam[1] + win_lam[2]
            best = bary_out[:, y0:y1, x0:x1].reshape(3, p)
            bary_out[:, y0:y1, x0:x1] = torch.where(
                closer[None], win_lam / torch.where(lam_sum != 0, lam_sum, 1.0),
                best).reshape(3, y1 - y0, w_)
    return VisibilityBuffer(depth=depth_out, tri_id=id_out, bary=bary_out)


def kernel_scratch_bytes(t_cap: int, width: int, height: int) -> int:
    """The scratch bytes of a kernel call over ``t_cap`` triangles into a
    ``width`` x ``height`` image (the records, boxes and cell lists), as
    the kernel's library counts them (built on first use)."""
    fn = LIBRARY.load().rtt_scan_raster_scratch
    fn.restype = ctypes.c_longlong
    return fn(t_cap, width, height)


def kernel_design(t_cap: int, width: int, height: int) -> dict:
    """The kernel's sizes for a call over ``t_cap`` triangles into a
    ``width`` x ``height`` image, read from its library (built on first
    use): pixel region (a pixel per lane), warps per 8 x 4 area, fine
    cell, the list capacity per fine cell, triangles per group box and per
    stage."""
    out = (ctypes.c_int * 8)()
    LIBRARY.load().rtt_scan_raster_design(t_cap, width, height, out)
    rw, rh, k, cw, ch, cap, group, stage = out
    return dict(region=(rw, rh), warps_per_area=k, cell=(cw, ch), cell_capacity=cap,
                group=group, stage=stage)


def scan_raster_kernel(inp: ScanInputs, count, width: int, height: int, tri_block: int = 128,
                       with_bary: bool = True) -> VisibilityBuffer:
    """Same arguments and result as ``scan_raster_plain``; CUDA tensors
    only. The count (a 0-dim int32 tensor on the card, or None) is read by
    the kernel on the device. Its records, boxes and cell lists go to
    scratch allocated here. ``SCAN_RASTER.launches`` counts the
    launches."""
    t_cap = inp.adj.shape[0]
    dev = inp.adj.device
    index = check_inputs(
        "scan raster",
        (inp.adj, torch.float32, (t_cap, 3, 3)),
        (inp.bb, torch.float32, (t_cap, 4)),
        (inp.top_left, torch.bool, (t_cap, 3)),
        (inp.tri_ok, torch.bool, (t_cap,)),
        (inp.zs, torch.float32, (t_cap, 3)),
        (inp.ws, torch.float32, (t_cap, 3)),
        *(() if count is None else ((count, torch.int32, ()),)),
    )
    depth = torch.empty((height, width), dtype=torch.float32, device=dev)
    tri_id = torch.empty((height, width), dtype=torch.int32, device=dev)
    bary = torch.empty((3, height, width), dtype=torch.float32, device=dev)
    scratch_size = kernel_scratch_bytes(t_cap, width, height)
    scratch = torch.empty((scratch_size,), dtype=torch.uint8, device=dev)
    SCAN_RASTER.launch(index, inp.adj.data_ptr(), inp.bb.data_ptr(), inp.top_left.data_ptr(),
                       inp.tri_ok.data_ptr(), inp.zs.data_ptr(), inp.ws.data_ptr(),
                       None if count is None else count.data_ptr(), t_cap, tri_block, width,
                       height, int(with_bary), scratch.data_ptr(), scratch_size,
                       depth.data_ptr(), tri_id.data_ptr(), bary.data_ptr())
    return VisibilityBuffer(depth=depth, tri_id=tri_id, bary=bary)


def rasterize_scan(clip: torch.Tensor, valid: torch.Tensor, width: int, height: int,
                   cull_backface: bool = True, tri_block: int = 128,
                   with_bary: bool = True, count=None) -> VisibilityBuffer:
    """Rasterize a (T, 3, 4) clip-space soup with its (T,) valid mask into
    a visibility buffer (depth, tri_id, barycentrics (3, H, W); zeros
    without ``with_bary``), walking the blocks below ceil(count /
    tri_block) (every block when ``count`` is None). The kernel on the
    card, the plain version on the CPU."""
    t_cap = clip.shape[0]
    tri_block = min(tri_block, t_cap)
    if t_cap % tri_block:
        raise ValueError(f"the soup's {t_cap} triangles are not a multiple of {tri_block}")
    inp = scan_inputs(clip, valid, width, height, cull_backface)
    if clip.is_cuda:
        return scan_raster_kernel(inp, count, width, height, tri_block, with_bary)
    if clip.device.type != "cpu":
        raise ValueError(f"no scan raster kernel for device {clip.device}")
    return scan_raster_plain(inp, count, width, height, tri_block, with_bary)
