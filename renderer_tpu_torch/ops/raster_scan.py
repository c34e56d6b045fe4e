"""The independent scan rasterizer (``renderer_tpu.ops.raster_jax``'s
``rasterize``), in plain PyTorch.

It shares no code with kernel 1 (``ops/raster_cuda.py``) or its plain
version: no records, no binning, no tiles. Every triangle is tested
against every pixel of a row strip, block after block, with a running
(depth, id, barycentrics) reduction, following ``ops/raster_spec.py``'s
rules directly. The reference view (``passes/pipeline.py``) renders
through it, so that a fault of the main raster shows as a difference.

Sums are multiply-adds taken left to right. The loop runs over every
block of the soup (not just up to ``count``), so a frame never reads a
device value on the host.
"""

from __future__ import annotations

import torch

from renderer_tpu_torch.ops.geometry import pixel_homogeneous
from renderer_tpu_torch.ops.raster_cuda import VisibilityBuffer
from renderer_tpu_torch.ops.raster_spec import DEPTH_CLEAR, FRONT_DET_SIGN, NO_TRIANGLE

STRIP_ELEMENTS = 1 << 22  # a strip's (block, edge, pixel) temporaries stay below this


def adjugate3(m: torch.Tensor) -> torch.Tensor:
    """Batched adjugate of (..., 3, 3)."""

    def c(i, j):  # the cofactor of entry (j, i)
        i1, i2, j1, j2 = (i + 1) % 3, (i + 2) % 3, (j + 1) % 3, (j + 2) % 3
        return m[..., j1, i1] * m[..., j2, i2] - m[..., j1, i2] * m[..., j2, i1]

    return torch.stack([torch.stack([c(i, j) for j in range(3)], dim=-1) for i in range(3)],
                       dim=-2)


def rasterize_scan(clip: torch.Tensor, valid: torch.Tensor, width: int, height: int,
                   cull_backface: bool = True, tri_block: int = 128) -> VisibilityBuffer:
    """Rasterize a (T, 3, 4) clip-space soup with its (T,) valid mask into
    a visibility buffer (depth, tri_id, barycentrics (3, H, W))."""
    t_cap = clip.shape[0]
    dev = clip.device
    tri_block = min(tri_block, t_cap)
    if t_cap % tri_block:
        raise ValueError(f"the soup's {t_cap} triangles are not a multiple of {tri_block}")
    u = pixel_homogeneous(clip, width, height)  # (T, corner, 3)
    m = u.transpose(-1, -2)  # columns are corners
    adj_raw = adjugate3(m)
    det = (m[:, 0, 0] * (m[:, 1, 1] * m[:, 2, 2] - m[:, 1, 2] * m[:, 2, 1])
           - m[:, 0, 1] * (m[:, 1, 0] * m[:, 2, 2] - m[:, 1, 2] * m[:, 2, 0])
           + m[:, 0, 2] * (m[:, 1, 0] * m[:, 2, 1] - m[:, 1, 1] * m[:, 2, 0]))
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

    strip_rows = max(1, min(height, STRIP_ELEMENTS // (3 * tri_block * width)))
    depth_out, id_out, bary_out = [], [], []
    for r0 in range(0, height, strip_rows):
        rows = min(strip_rows, height - r0)
        qx = (torch.arange(width, dtype=torch.float32, device=dev) + 0.5).repeat(rows)
        qy = (torch.arange(rows, dtype=torch.float32, device=dev) + (r0 + 0.5)).repeat_interleave(width)
        p = rows * width
        depth = torch.full((p,), DEPTH_CLEAR, dtype=torch.float32, device=dev)
        best_id = torch.full((p,), NO_TRIANGLE, dtype=torch.int32, device=dev)
        best_bary = torch.zeros((3, p), dtype=torch.float32, device=dev)
        for b0 in range(0, t_cap, tri_block):
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
            win_lam = lam.gather(0, win[None, None].expand(1, 3, p))[0]  # (3, P)
            closer = win_z < depth
            depth = torch.where(closer, win_z, depth)
            best_id = torch.where(closer, (win + b0).to(torch.int32), best_id)
            lam_sum = win_lam[0] + win_lam[1] + win_lam[2]
            best_bary = torch.where(closer[None], win_lam / torch.where(lam_sum != 0, lam_sum, 1.0),
                                    best_bary)
        depth_out.append(depth.reshape(rows, width))
        id_out.append(best_id.reshape(rows, width))
        bary_out.append(best_bary.reshape(3, rows, width))
    return VisibilityBuffer(depth=torch.cat(depth_out), tri_id=torch.cat(id_out),
                            bary=torch.cat(bary_out, dim=1))
