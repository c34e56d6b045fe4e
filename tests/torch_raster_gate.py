"""The float64-reference gate for the port's rasterizer.

Holds a visibility buffer to ``renderer_tpu.ops.raster_ref.rasterize_ref``
(float64 numpy): tri_id equal, depth within 1e-5, barycentrics within
2e-3, with two float32 allowances that the JAX package's float32
rasterizers share: a pixel centre within rounding of an edge may flip (at
most 0.05% of pixels), and triangles with a corner behind the eye keep
depth within 2e-4 (the JAX suite's float32-vs-float64 depth gate).
"""

import numpy as np

from renderer_tpu.ops.raster_ref import rasterize_ref

DEPTH_ATOL = 1e-5
BARY_ATOL = 2e-3
REF_FLIP_FRACTION = 5e-4
REF_DEPTH_ATOL_W_CROSSING = 2e-4


def reference_gate(tri_id, depth, bary, clip, valid, w, h, cull) -> dict:
    """Hold a visibility buffer (numpy: (H,W) tri_id and depth, (3,H,W)
    bary or None) to rasterize_ref. Raises AssertionError; returns the
    measured errors."""
    t = len(clip)
    ref = rasterize_ref(clip.reshape(-1, 4), np.arange(3 * t).reshape(t, 3), w, h,
                        cull_backface=cull, tri_valid=valid)
    same = tri_id == ref.tri_id
    all_front = (clip[:, :, 3] > 1e-9).all(axis=1)
    front_px = same & ((ref.tri_id < 0) | all_front[np.maximum(ref.tri_id, 0)])
    depth_err = np.abs(depth - ref.depth)
    out = {
        "flipped": int((~same).sum()),
        "depth_err": float(depth_err[front_px].max(initial=0.0)),
        "depth_err_w_crossing": float(depth_err[same].max(initial=0.0)),
        "bary_err": 0.0,
    }
    if bary is not None:
        out["bary_err"] = float(
            np.abs(np.moveaxis(bary, 0, -1) - ref.bary)[same].max(initial=0.0)
        )
    assert out["flipped"] <= REF_FLIP_FRACTION * tri_id.size, out
    assert out["depth_err"] <= DEPTH_ATOL, out
    assert out["depth_err_w_crossing"] <= REF_DEPTH_ATOL_W_CROSSING, out
    assert out["bary_err"] <= BARY_ATOL, out
    return out
