"""Two-pass occlusion culling against the previous frame's depth
(``renderer_tpu.ops.occlusion``).

A max-mip pyramid over frame N-1's depth holds, per texel, the farthest
occluder of its footprint. At frame N each coarse-cull survivor's world
AABB is projected with frame N-1's viewproj (the space that depth was
rendered in); where its nearest depth lies behind the farthest occluder of
the pyramid texels covering its screen bbox, it cannot be seen. An
instance with a corner at or behind the previous camera's eye plane, or
too big for the top level's 4x4 window, is never culled.
"""

from __future__ import annotations

import torch

from renderer_tpu_torch.mathx.transforms import transform_aabb
from renderer_tpu_torch.ops.geometry import mats44
from renderer_tpu_torch.scene.types import Scene

LEVELS = 6


def build_depth_pyramid(depth: torch.Tensor, levels: int) -> list:
    """Max-mip chain of an (H, W) depth buffer (1.0 = far): [(H/2, W/2),
    (H/4, W/4), ...], ``levels`` of them; H and W divisible by 2^levels."""
    out = []
    d = depth
    for _ in range(levels):
        h, w = d.shape
        d = d.reshape(h // 2, 2, w // 2, 2).amax(dim=(1, 3))
        out.append(d)
    return out


def occlusion_cull(scene: Scene, model: torch.Tensor, viewproj_prev: torch.Tensor,
                   visible: torch.Tensor, prev_depth: torch.Tensor,
                   levels: int = LEVELS) -> torch.Tensor:
    """(N,) bool: ``visible`` less the instances that frame N-1's depth
    (``prev_depth`` (H, W), rendered with ``viewproj_prev``) hides. The
    pyramid level is the one whose texel (2^(l+1) pixels) covers the
    projected bbox's larger extent; a 2x2 texel window decides (4x4 at the
    top level, where larger boxes clamp)."""
    h, w = prev_depth.shape
    pyramid = build_depth_pyramid(prev_depth, levels)
    mesh_id = scene.instances.mesh_id.long()
    wmin, wmax = transform_aabb(mats44(model), scene.meshes.mesh_aabb_min[mesh_id],
                                scene.meshes.mesh_aabb_max[mesh_id])
    # the 8 corners (bit 2: x, bit 1: y, bit 0: z; set = max), each (N, 8)
    sel = torch.arange(8, device=wmin.device)
    corner = [torch.where((sel & bit) != 0, wmax[:, k, None], wmin[:, k, None])
              for k, bit in enumerate((4, 2, 1))]
    vp = viewproj_prev
    clip = [vp[i, 0] * corner[0] + vp[i, 1] * corner[1] + vp[i, 2] * corner[2] + vp[i, 3]
            for i in range(4)]
    cw = clip[3]
    safe = (cw > 1e-6).all(dim=-1)  # no corner at or behind the eye plane
    safe_w = torch.where(cw.abs() > 1e-9, cw, 1e-9)
    px = (clip[0] / safe_w + 1.0) * (0.5 * w)
    py = (1.0 - clip[1] / safe_w) * (0.5 * h)
    zmin = (clip[2] / safe_w).amin(dim=-1)  # the instance's nearest depth
    x0 = torch.clamp(px.amin(dim=-1), 0.0, w - 1.0)
    x1 = torch.clamp(px.amax(dim=-1), 0.0, w - 1.0)
    y0 = torch.clamp(py.amin(dim=-1), 0.0, h - 1.0)
    y1 = torch.clamp(py.amax(dim=-1), 0.0, h - 1.0)

    extent = torch.maximum(x1 - x0, y1 - y0)
    lvl = torch.clamp(torch.ceil(torch.log2(torch.clamp(extent, min=1.0))).int() - 1,
                      0, levels - 1)
    # the top level's 4x4 window covers extents up to 3 top texels; a larger
    # box must never be culled on a corner sample of its own depth
    too_big = extent > 3.0 * (2 << (levels - 1))
    occluded = torch.zeros_like(visible)
    for lv, d in enumerate(pyramid):
        scale = 2 << lv  # pixels per texel
        lh, lw = d.shape
        taps = torch.arange(4 if lv == levels - 1 else 2, device=d.device)
        tx = torch.clamp(torch.clamp((x0 / scale).long(), 0, lw - 1)[:, None] + taps, max=lw - 1)
        ty = torch.clamp(torch.clamp((y0 / scale).long(), 0, lh - 1)[:, None] + taps, max=lh - 1)
        far = d[ty[:, :, None], tx[:, None, :]].amax(dim=(1, 2))  # the window's farthest texel
        occluded = torch.where(lvl == lv, zmin > far, occluded)
    return visible & ~(occluded & safe & ~too_big)
