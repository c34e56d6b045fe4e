"""The minimal forward frame as one function (``renderer_tpu.passes.forward``).

``render_forward`` is the plain configuration without the plan: instance
matrices, the coarse frustum cull and LOD pick, the draw-stream
expansion, the per-triangle cull, the scan rasterizer and Lambert
shading. It runs on the device of the scene's tensors (the card, unless
the scene was built with ``device="cpu"``) and reads nothing back.
"""

from __future__ import annotations

import torch

from renderer_tpu_torch.mathx.camera import Camera
from renderer_tpu_torch.ops import geometry
from renderer_tpu_torch.ops.raster_scan import rasterize_scan
from renderer_tpu_torch.ops.shading import shade_lambert
from renderer_tpu_torch.scene.types import Scene


def render_forward(scene: Scene, camera: Camera, width: int = 256, height: int = 256,
                   tri_capacity: int = 2048, cull_backface: bool = True):
    """Render the scene -> ((H, W, 3) linear colour, the visibility buffer).
    ``tri_capacity`` bounds the expanded triangles (a multiple of 128)."""
    model = geometry.instance_matrices(scene)
    vp, clip_mats = geometry.camera_clip_matrices(camera, model)
    visible = geometry.coarse_cull(scene, model, vp)
    lod = geometry.select_lod(scene, camera, model)
    soup = geometry.expand_draw_stream(scene, visible, lod, clip_mats, model, tri_capacity)
    soup = geometry.cull_triangles(soup, cull_backface=cull_backface)
    vis = rasterize_scan(soup.clip, soup.valid, width, height, cull_backface=cull_backface)
    img = shade_lambert(vis, soup, scene, camera.position, torch.linalg.inv_ex(vp).inverse)
    return img, vis
