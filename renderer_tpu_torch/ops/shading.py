"""Shading of the debug view (``renderer_tpu.ops.shading``): flat colour per
instance. PBR shading is ``ops/pbr.py``."""

from __future__ import annotations

import torch

from renderer_tpu_torch.ops.debug import instance_debug_colors
from renderer_tpu_torch.ops.geometry import TriangleSoup
from renderer_tpu_torch.ops.raster_cuda import VisibilityBuffer
from renderer_tpu_torch.ops.raster_spec import NO_TRIANGLE


def interpolate(vis: VisibilityBuffer, attr: torch.Tensor, fill: float = 0.0) -> torch.Tensor:
    """Perspective-correct interpolation of (T, 3, C) corner attributes
    through the visibility buffer's barycentrics -> channel-first (C, H, W),
    ``fill`` where no triangle covers the pixel."""
    safe = torch.clamp(vis.tri_id, min=0).long()
    covered = vis.tri_id != NO_TRIANGLE
    planes = []
    for c in range(attr.shape[-1]):
        acc = vis.bary[0] * attr[:, 0, c][safe]
        for k in (1, 2):
            acc = acc + vis.bary[k] * attr[:, k, c][safe]
        planes.append(torch.where(covered, acc, fill))
    return torch.stack(planes, dim=0)


def shade_flat_instance(vis: VisibilityBuffer, soup: TriangleSoup,
                        background=(0.05, 0.05, 0.08)) -> torch.Tensor:
    """(H, W, 3): each covered pixel in its instance's debug colour times
    |n_y| * 0.3 + 0.7 of the interpolated normal (a facing cue), the
    background elsewhere."""
    covered = vis.tri_id != NO_TRIANGLE
    inst = soup.instance[torch.clamp(vis.tri_id, min=0).long()]
    color = instance_debug_colors(inst).permute(2, 0, 1)  # (3, H, W)
    ny = interpolate(vis, soup.normal)[1:2].abs() * 0.3 + 0.7
    bg = torch.stack([torch.full((), float(c), device=color.device) for c in background])
    out = torch.where(covered[None], color * ny, bg[:, None, None])
    return out.permute(1, 2, 0)
