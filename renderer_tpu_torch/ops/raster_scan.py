"""The independent scan rasterizer (``renderer_tpu.ops.raster_jax``'s
``rasterize``), in plain PyTorch.

It shares no code with kernel 1 (``ops/raster_cuda.py``) or its plain
version: no records, no binning, no tiles. Every triangle is tested
against every pixel of a window, block after block, with a running
(depth, id, barycentrics) reduction, following ``ops/raster_spec.py``'s
rules directly. The plain configuration (``PipelineConfig(tile_raster=
False)``) renders its frames and its shadow atlas through it, and the
reference view renders through it, so that a fault of the main raster
shows as a difference.

Sums are multiply-adds taken left to right. On the card the windows are
row strips and every block of the soup walks every strip, so a frame never
reads a device value on the host (the JAX package bounds its loop by the
soup's count; the port takes none). On the CPU a host read costs no wait,
so each block walks only the window its live triangles' bboxes reach, and
blocks without one are skipped: a pixel outside every bbox of a block is
covered by none of its triangles, so the output is the same either way.
"""

from __future__ import annotations

import math

import torch

from renderer_tpu_torch.ops.geometry import adjugate3, det3, pixel_homogeneous
from renderer_tpu_torch.ops.raster_cuda import VisibilityBuffer
from renderer_tpu_torch.ops.raster_spec import DEPTH_CLEAR, FRONT_DET_SIGN, NO_TRIANGLE

# (triangle, edge, pixel) elements of one step's temporaries: fewer, larger
# steps on the card (each step is ~30 launches), smaller ones on the CPU
STEP_ELEMENTS = {"cuda": 1 << 27, "cpu": 1 << 22}


def _windows(bb, tri_ok, tri_block: int, width: int, height: int, device) -> list:
    """The walk as (x0, x1, y0, y1, block starts) windows, each cut into
    row bands within the step budget. On the card: the whole frame, every
    block. On the CPU: per block holding a live triangle, the pixels whose
    centres its live bboxes reach (one pixel of margin)."""
    t_cap = tri_ok.shape[0]
    budget = STEP_ELEMENTS["cpu" if device.type == "cpu" else "cuda"]
    if device.type != "cpu":
        wins = [(0, width, 0, height, list(range(0, t_cap, tri_block)))]
    else:
        inf = math.inf
        ok = tri_ok[:, None]
        # a NaN bound covers nothing (every comparison with it is false)
        lo = torch.where(ok, torch.nan_to_num(bb[:, 0::2], nan=inf), inf)
        hi = torch.where(ok, torch.nan_to_num(bb[:, 1::2], nan=-inf), -inf)
        lo = lo.reshape(-1, tri_block, 2).amin(dim=1).tolist()
        hi = hi.reshape(-1, tri_block, 2).amax(dim=1).tolist()
        wins = []
        for k, ((xl, yl), (xh, yh)) in enumerate(zip(lo, hi)):
            if xl > xh or yl > yh:
                continue
            x0, y0 = (max(0, math.floor(max(v, -1.0) - 0.5)) for v in (xl, yl))
            x1 = min(width, math.floor(min(xh, width + 1.0) - 0.5) + 2)
            y1 = min(height, math.floor(min(yh, height + 1.0) - 0.5) + 2)
            if x0 < x1 and y0 < y1:
                wins.append((x0, x1, y0, y1, [k * tri_block]))
    out = []
    for x0, x1, y0, y1, blocks in wins:
        rows = max(1, budget // (3 * tri_block * (x1 - x0)))
        out += [(x0, x1, r0, min(r0 + rows, y1), blocks) for r0 in range(y0, y1, rows)]
    return out


def rasterize_scan(clip: torch.Tensor, valid: torch.Tensor, width: int, height: int,
                   cull_backface: bool = True, tri_block: int = 128,
                   with_bary: bool = True) -> VisibilityBuffer:
    """Rasterize a (T, 3, 4) clip-space soup with its (T,) valid mask into
    a visibility buffer (depth, tri_id, barycentrics (3, H, W); zeros
    without ``with_bary``)."""
    t_cap = clip.shape[0]
    dev = clip.device
    tri_block = min(tri_block, t_cap)
    if t_cap % tri_block:
        raise ValueError(f"the soup's {t_cap} triangles are not a multiple of {tri_block}")
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
    zs, ws = clip[..., 2], clip[..., 3]
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

    depth_out = torch.full((height, width), DEPTH_CLEAR, dtype=torch.float32, device=dev)
    id_out = torch.full((height, width), NO_TRIANGLE, dtype=torch.int32, device=dev)
    bary_out = torch.zeros((3, height, width), dtype=torch.float32, device=dev)
    for x0, x1, y0, y1, blocks in _windows(bb, tri_ok, tri_block, width, height, dev):
        w_, p = x1 - x0, (y1 - y0) * (x1 - x0)
        qx = (torch.arange(x0, x1, dtype=torch.float32, device=dev) + 0.5).repeat(y1 - y0)
        qy = (torch.arange(y0, y1, dtype=torch.float32, device=dev) + 0.5).repeat_interleave(w_)
        depth = depth_out[y0:y1, x0:x1].reshape(p)
        best_id = id_out[y0:y1, x0:x1].reshape(p)
        best_bary = bary_out[:, y0:y1, x0:x1].reshape(3, p)
        for b0 in blocks:
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
            depth = torch.where(closer, win_z, depth)
            best_id = torch.where(closer, (win + b0).to(torch.int32), best_id)
            if with_bary:
                win_lam = lam.gather(0, win[None, None].expand(1, 3, p))[0]  # (3, P)
                lam_sum = win_lam[0] + win_lam[1] + win_lam[2]
                best_bary = torch.where(
                    closer[None], win_lam / torch.where(lam_sum != 0, lam_sum, 1.0), best_bary)
        depth_out[y0:y1, x0:x1] = depth.reshape(y1 - y0, w_)
        id_out[y0:y1, x0:x1] = best_id.reshape(y1 - y0, w_)
        bary_out[:, y0:y1, x0:x1] = best_bary.reshape(3, y1 - y0, w_)
    return VisibilityBuffer(depth=depth_out, tri_id=id_out, bary=bary_out)
