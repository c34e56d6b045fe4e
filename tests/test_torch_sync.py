"""The frame makes no blocking host-device synchronization: after warm-up,
the base, rt, shadowed exact and shadowed checkerboard+fix frames, the
occlusion-culled, frozen, debug-AABB and cluster-culled ones, and the
skinned (pose pass and per-corner cull), quarter-rate, SSAA, Lambert,
reference-view and HUD ones render
under ``torch.cuda.set_sync_debug_mode("error")``, which raises on any
operation that waits for the card (a blocking copy between host and card,
``.item()``, ``nonzero``, a stream synchronization). The cameras are made
by ``orbit_camera`` inside that window, as a render loop makes them, and
so are the HUD's overlay tables (host numpy, copied pinned). On the card
only:

    python -m pytest tests/test_torch_sync.py -m gpu -q
"""

import dataclasses

import pytest
import torch

from renderer_tpu_torch.mathx import orbit_camera
from renderer_tpu_torch.models import sponza_like_scene
from renderer_tpu_torch.ops.overlay import hud_overlay
from renderer_tpu_torch.passes.pipeline import PipelineConfig
from renderer_tpu_torch.runtime import Renderer

CFG = PipelineConfig(width=256, height=128, tri_capacity=8192, aa="edge", trilinear=False,
                     shadow_size=256)
FRAMES = {  # name -> (config changes, switches)
    "base": ({}, {}),
    "skinned": (dict(skinning=True), {}),
    "quarter_fix": (dict(shade_rate="quarter"), {}),
    "ssaa2": (dict(ssaa=2), {}),
    "lambert": (dict(shading="lambert", aa="none"), {}),
    "reference_image": ({}, dict(reference_image=True)),
    "hud": ({}, dict(hud=True)),
    "rt": ({}, dict(rt=True)),
    "shadowed_exact": ({}, dict(shadows=True)),
    "shadowed_checkerboard_fix": (dict(shade_rate="checkerboard"), dict(shadows=True)),
    "shadowed_progressive": (dict(shade_rate="checkerboard", shadow_update_budget=1,
                                  shadow_progressive=4), dict(shadows=True)),
    "occlusion": ({}, dict(occlusion_culling=True)),
    "freeze": ({}, dict(freeze_culling=True)),
    "debug_aabbs": ({}, dict(debug_aabbs=True)),
    "cluster_cull": (dict(cluster_cull=True), {}),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(FRAMES))
def test_frame_makes_no_blocking_sync(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    changes, switches = FRAMES[name]
    aspect = CFG.width / CFG.height
    r = Renderer(sponza_like_scene(256, device=dev), dataclasses.replace(CFG, **changes),
                 device=dev)
    def frame(k):
        overlay = hud_overlay(f"frame {k}\nHUD 1.25 ms", CFG.width) if "hud" in switches else None
        return r.render(orbit_camera(0.3 + 0.01 * k, aspect, dev), time_s=k / 60.0,
                        overlay=overlay)

    for k in range(3):  # warm-up: kernels built, plan and cache state made
        if k == 1:  # after one frame without them: freezing keeps a culled list
            r.set_config(**switches)
            r.apply_config_now()
        frame(k)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for k in range(3, 6):
            out = frame(k)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    img = out["image"]
    assert img.shape == (CFG.height, CFG.width, 3) and bool(torch.isfinite(img).all())
