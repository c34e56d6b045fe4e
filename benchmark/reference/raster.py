"""The reference rasterizer: the rasterization specification of the port's
kernel 1 (clipless homogeneous edge functions, the top-left fill rule,
per-pixel w > 0 and 0 <= z <= 1 unless the triangle's 64-triangle block is
"simple", a strict depth test by cross-multiplication in which the lower
triangle id wins a tie) evaluated over (triangle, pixel) pairs in plain
PyTorch, with no tiles, bin lists or kernel.

Triangle setup (``setup_tri_data``) is a frozen copy of the port's
``renderer_tpu_torch/ops/raster_cuda.py``. The pairs of each band of rows
are every pixel inside a triangle's bounding box (widened by a pixel; the
exact box test is applied per pair, as the kernel applies it), sorted by
pixel and then triangle id; each pixel then takes its covering triangles
in ascending id, one rank at a time, with the kernel's update. So the
result equals kernel 1's bit for bit wherever each operation rounds alike
(the kernel is built with ``-fmad=false``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference.constants import DEPTH_CLEAR, FRONT_DET_SIGN, NO_TRIANGLE

BLOCK = 64  # triangles per record block (the "simple" flag is per block)
ROWS = 32   # floats per triangle record
R_E = 0     # 0..8 oriented edge coefficients (e0 a,b,c, e1, e2)
R_Z = 9     # 9..11 z_clip per corner
R_W = 12    # 12..14 w_clip per corner
R_BB = 15   # 15..18 bbox xmin, xmax, ymin, ymax in pixels (+-inf if dead)
R_TL = 19   # 19..21 top-left flag per edge (1.0 / 0.0)
MAX_PAIRS = 1 << 23  # pairs per pass of the pair loop


class Visibility(NamedTuple):
    depth: torch.Tensor   # (H, W) f32, DEPTH_CLEAR where empty
    tri_id: torch.Tensor  # (H, W) i32, NO_TRIANGLE where empty


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


def _pair_ranges(bb, ok, width: int, y_lo: int, y_hi: int):
    """Per triangle, the pixel rectangle of its bounding box (widened by one
    pixel) within rows [y_lo, y_hi): (x0, nx, ya, ny), empty where not ok."""
    xmin, xmax, ymin, ymax = bb
    big = float(1 << 24)

    def lo(v, hi):
        return torch.clamp(torch.floor(torch.clamp(v, -big, big) - 0.5) - 1, 0, hi).long()

    def up(v, hi):
        return torch.clamp(torch.ceil(torch.clamp(v, -big, big) - 0.5) + 1, -1, hi).long()

    x0, x1 = lo(xmin, width - 1), up(xmax, width - 1)
    ya = torch.clamp(lo(ymin, y_hi - 1), min=y_lo)
    yb = torch.clamp(up(ymax, y_hi - 1), min=y_lo - 1)
    nx = torch.clamp(x1 - x0 + 1, min=0)
    ny = torch.clamp(yb - ya + 1, min=0)
    n = torch.where(ok, nx * ny, 0)
    return x0, nx, ya, n


def _covering_pairs(rec, simple_tri, tri, x, y):
    """The kernel's coverage test of (triangle, pixel) pairs and its depth
    terms: (covered, z_num, w_i) with the plain version's operation order."""
    px = x.to(torch.float32) + 0.5
    py = y.to(torch.float32) + 0.5
    r = rec[tri]
    lam = [r[:, R_E + 3 * e] * px + r[:, R_E + 3 * e + 1] * py + r[:, R_E + 3 * e + 2]
           for e in range(3)]
    w_i = lam[0] * r[:, R_W] + lam[1] * r[:, R_W + 1] + lam[2] * r[:, R_W + 2]
    z_num = lam[0] * r[:, R_Z] + lam[1] * r[:, R_Z + 1] + lam[2] * r[:, R_Z + 2]
    cov = torch.ones_like(px, dtype=torch.bool)
    for e in range(3):
        cov = cov & ((lam[e] > 0) | ((lam[e] == 0) & (r[:, R_TL + e] != 0)))
    cov = (cov & (px >= r[:, R_BB]) & (px <= r[:, R_BB + 1])
           & (py >= r[:, R_BB + 2]) & (py <= r[:, R_BB + 3]))
    cov = cov & (simple_tri[tri] | ((w_i > 0) & (z_num >= 0.0) & (z_num <= w_i)))
    return cov, z_num, w_i


def rasterize(clip, valid, width: int, height: int, cull_backface: bool = True,
              band_rows: int = 64) -> Visibility:
    """Rasterize (T, 3, 4) clip corners into a (height, width) depth and
    triangle-id buffer, kernel 1's result."""
    dev = clip.device
    t_cap = clip.shape[0]
    rec, (xmin, xmax, ymin, ymax, ok), simple = setup_tri_data(
        clip, valid, width, height, cull_backface)
    pad = (-t_cap) % BLOCK
    block_simple = torch.all(torch.nn.functional.pad(simple | ~ok, (0, pad), value=True)
                             .reshape(-1, BLOCK), dim=1)
    simple_tri = block_simple.repeat_interleave(BLOCK)[:t_cap]
    znum = torch.full((height * width,), DEPTH_CLEAR, dtype=torch.float32, device=dev)
    wden = torch.ones((height * width,), dtype=torch.float32, device=dev)
    tid = torch.full((height * width,), NO_TRIANGLE, dtype=torch.int32, device=dev)
    ids = torch.arange(t_cap, device=dev)
    for y_lo in range(0, height, band_rows):
        y_hi = min(height, y_lo + band_rows)
        x0, nx, ya, n = _pair_ranges((xmin, xmax, ymin, ymax), ok, width, y_lo, y_hi)
        live = n > 0
        t_live = ids[live]
        if t_live.numel() == 0:
            continue
        n_live = n[live]
        ends = torch.cumsum(n_live, 0)
        total = int(ends[-1])
        cov_t, cov_p, cov_z, cov_w = [], [], [], []
        start = 0
        while start < total:  # pairs in passes of at most MAX_PAIRS, whole triangles
            stop = min(total, start + MAX_PAIRS)
            first = int(torch.searchsorted(ends, torch.tensor(start, device=dev), right=True))
            last = int(torch.searchsorted(ends, torch.tensor(stop - 1, device=dev), right=True))
            stop = int(ends[last])
            seg = slice(first, last + 1)
            counts = n_live[seg]
            tri = torch.repeat_interleave(t_live[seg], counts)
            base = torch.repeat_interleave(ends[seg] - counts, counts)
            off = torch.arange(int(ends[first] - counts[0]), stop, device=dev) - base
            nxs = torch.repeat_interleave(nx[live][seg], counts)
            x = torch.repeat_interleave(x0[live][seg], counts) + off % nxs
            y = torch.repeat_interleave(ya[live][seg], counts) + off // nxs
            cov, z_num, w_i = _covering_pairs(rec, simple_tri, tri, x, y)
            cov_t.append(tri[cov])
            cov_p.append((y * width + x)[cov])
            cov_z.append(z_num[cov])
            cov_w.append(w_i[cov])
            start = stop
        tri, pix = torch.cat(cov_t), torch.cat(cov_p)
        if tri.numel() == 0:
            continue
        z_num, w_i = torch.cat(cov_z), torch.cat(cov_w)
        order = torch.sort(pix * t_cap + tri).indices  # by pixel, then ascending id
        tri, pix, z_num, w_i = tri[order], pix[order], z_num[order], w_i[order]
        first_of = torch.ones_like(pix, dtype=torch.bool)
        first_of[1:] = pix[1:] != pix[:-1]
        seg_start = torch.cummax(torch.where(first_of, torch.arange(pix.numel(), device=dev), 0),
                                 0).values
        rank = torch.arange(pix.numel(), device=dev) - seg_start
        by_rank = torch.sort(rank, stable=True).indices
        per_rank = torch.bincount(rank)
        at = 0
        for cnt in per_rank.tolist():  # rank r: each pixel's r-th covering triangle
            sel = by_rank[at: at + cnt]
            at += cnt
            p = pix[sel]
            zn, wi = z_num[sel], w_i[sel]
            closer = zn * wden[p] < znum[p] * wi
            p = p[closer]
            znum[p] = zn[closer]
            wden[p] = wi[closer]
            tid[p] = tri[sel][closer].to(torch.int32)
    depth = (znum / wden).reshape(height, width)
    return Visibility(depth=depth, tri_id=tid.reshape(height, width))
