"""Frozen copy of the port's ``renderer_tpu_torch/ops/aa.py`` (the benchmark's plain
reference; it imports nothing of the port, and the port may change
without it). What follows is the original's docstring.

Edge-aware morphological anti-aliasing on the visibility buffer
(``renderer_tpu.ops.aa``): an FXAA-class directional blend that runs only
on triangle-id edges, built from shifted whole-image planes.
"""

from __future__ import annotations

import torch

_LW = (0.2126, 0.7152, 0.0722)  # rec.709 luma
EDGE_TAU = 0.0312  # FXAA's low contrast floor
SUBPIX_CAP = 0.75  # FXAA subpix quality


def halo_rows(arrays, halo=None) -> list:
    """Per (..., H, W) array, (the row above its first, the row below its
    last): with ``halo`` (the ``parallel.sharding.Shard`` of a split frame,
    whose rows are a band of the image) the neighbouring shards' rows,
    else clamp-to-edge rows (the JAX package's ``pbr._halo_rows``)."""
    if halo is None:
        return [(a[..., :1, :], a[..., -1:, :]) for a in arrays]
    return halo.halo_rows(*arrays)


def _up(a, above=None):
    """Each row's upper neighbour; the first row's is ``above`` (default:
    itself)."""
    return torch.cat([a[..., :1, :] if above is None else above, a[..., :-1, :]], dim=-2)


def _dn(a, below=None):
    return torch.cat([a[..., 1:, :], a[..., -1:, :] if below is None else below], dim=-2)


def _left(a):
    return torch.cat([a[..., :, :1], a[..., :, :-1]], dim=-1)


def _right(a):
    return torch.cat([a[..., :, 1:], a[..., :, -1:]], dim=-1)


def edge_aa(color: torch.Tensor, tri_id: torch.Tensor, halo=None) -> torch.Tensor:
    """(3, H, W) HDR colour -> (3, H, W) anti-aliased. tri_id: (H, W)
    visibility-buffer ids (the background id counts, so silhouettes are
    edges). ``halo``: the shard of a split frame, whose edge rows read the
    neighbouring shards' (``halo_rows``)."""
    cl = torch.clamp(color, 0.0, 1.0)
    luma = _LW[0] * cl[0] + _LW[1] * cl[1] + _LW[2] * cl[2]
    (t_a, t_b), (l_a, l_b), (c_a, c_b) = halo_rows((tri_id, luma, color), halo)

    id_edge = (
        (tri_id != _up(tri_id, t_a)) | (tri_id != _dn(tri_id, t_b))
        | (tri_id != _right(tri_id)) | (tri_id != _left(tri_id))
    )
    l_n, l_s, l_e, l_w = _up(luma, l_a), _dn(luma, l_b), _right(luma), _left(luma)
    l_max = torch.maximum(luma, torch.maximum(torch.maximum(l_n, l_s), torch.maximum(l_e, l_w)))
    l_min = torch.minimum(luma, torch.minimum(torch.minimum(l_n, l_s), torch.minimum(l_e, l_w)))
    rng = l_max - l_min
    edge = id_edge & (rng >= EDGE_TAU)

    # orientation: luma varies more across a horizontal edge vertically
    gv = (l_n - luma).abs() + (l_s - luma).abs()
    gh = (l_e - luma).abs() + (l_w - luma).abs()
    horizontal = gv >= gh
    pick_n = (l_n - luma).abs() >= (l_s - luma).abs()
    pick_e = (l_e - luma).abs() >= (l_w - luma).abs()
    nb = torch.where(
        horizontal[None],
        torch.where(pick_n[None], _up(color, c_a), _dn(color, c_b)),
        torch.where(pick_e[None], _right(color), _left(color)),
    )
    # FXAA sub-pixel weight: distance from the cross-neighbour average,
    # normalized by the local range
    avg4 = (l_n + l_s + l_e + l_w) * 0.25
    subpix = torch.clamp((avg4 - luma).abs() / torch.clamp(rng, min=1e-6), 0.0, 1.0)
    w = torch.where(edge, subpix * subpix * SUBPIX_CAP, 0.0)
    return color + w[None] * (nb - color)
