"""Simple shading models (``renderer_tpu.ops.shading``): Lambert, and the
debug view's flat colour per instance. PBR shading is ``ops/pbr.py``.
Both read the soup's corner attributes through the raster's barycentrics."""

from __future__ import annotations

import torch

from renderer_tpu_torch.ops.debug import instance_debug_colors
from renderer_tpu_torch.ops.geometry import TriangleSoup, unproject_depth
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


def _background(background, device) -> torch.Tensor:
    """(3, 1, 1) background colour made on the device (no host copy)."""
    return torch.stack([torch.full((1, 1), float(c), device=device) for c in background])


def shade_lambert(vis: VisibilityBuffer, soup: TriangleSoup, scene, camera_pos: torch.Tensor,
                  viewproj_inv: torch.Tensor, background=(0.05, 0.05, 0.08),
                  ambient: float = 0.15, y0: int = 0, full_height: int = None) -> torch.Tensor:
    """(H, W, 3) Lambert-shaded linear colour: the instance material's base
    colour times ambient plus every live light's n.l (point lights fall off
    with 1/d^2), plus emissive; the background where nothing is covered.
    The buffer holds rows [y0, y0 + H) of a full_height frame."""
    covered = vis.tri_id != NO_TRIANGLE
    h, w = vis.depth.shape
    world = unproject_depth(vis.depth, viewproj_inv, w, h, y0=y0,
                            full_height=full_height)  # (3, H, W)
    normal = interpolate(vis, soup.normal)
    n = normal / torch.clamp(torch.sqrt((normal * normal).sum(dim=0, keepdim=True)), min=1e-8)
    mat_id = scene.instances.material_id.long()[soup.instance[torch.clamp(vis.tri_id,
                                                                             min=0).long()]]
    mats = scene.materials
    albedo = mats.base_color_factor[:, :3][mat_id].permute(2, 0, 1)
    emissive = mats.emissive[mat_id].permute(2, 0, 1)
    lights = scene.lights
    radiance = torch.full_like(albedo, ambient)
    for li in range(lights.alive.shape[0]):
        pos = lights.position[li][:, None, None]
        directional = lights.directional[li]
        to_light = torch.where(directional, -pos * torch.ones_like(world), pos - world)
        dist2 = (to_light * to_light).sum(dim=0, keepdim=True)
        l = to_light / torch.sqrt(torch.clamp(dist2, min=1e-12))
        ndotl = torch.clamp((n * l).sum(dim=0, keepdim=True), min=0.0)
        atten = torch.where(directional, 1.0, 1.0 / torch.clamp(dist2, min=1e-4))
        contrib = ndotl * atten * lights.intensity[li] * lights.color[li][:, None, None]
        radiance = radiance + torch.where(lights.alive[li], contrib, 0.0)
    color = albedo * radiance + emissive
    color = torch.where(covered[None], color, _background(background, color.device))
    return color.permute(1, 2, 0)


def shade_flat_instance(vis: VisibilityBuffer, soup: TriangleSoup,
                        background=(0.05, 0.05, 0.08)) -> torch.Tensor:
    """(H, W, 3): each covered pixel in its instance's debug colour times
    |n_y| * 0.3 + 0.7 of the interpolated normal (a facing cue), the
    background elsewhere."""
    covered = vis.tri_id != NO_TRIANGLE
    inst = soup.instance[torch.clamp(vis.tri_id, min=0).long()]
    color = instance_debug_colors(inst).permute(2, 0, 1)  # (3, H, W)
    ny = interpolate(vis, soup.normal)[1:2].abs() * 0.3 + 0.7
    out = torch.where(covered[None], color * ny, _background(background, color.device))
    return out.permute(1, 2, 0)
