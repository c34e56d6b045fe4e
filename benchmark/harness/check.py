"""The output check: what the window rendered against the plain reference
(``benchmark/reference/``), number by number, each beside its limit.

Compared, at the window frames the seed draws and at the window's last
frame:

- ``vis_mismatch``: the share of pixels whose visible triangle (an index
  into the cull's sorted soup, so the cull's order is held too) differs;
- ``depth_err``: the largest depth difference where the triangles agree;
- ``image_err``: the largest difference of a colour channel over the
  pixels whose 3x3 neighbourhood sees the same triangles on both sides
  (edge AA and the checkerboard's rebuild read the neighbours);

and at the last frame, from the renderer's state after the window:

- ``draw_mismatch``: the soup slots whose (valid, instance, triangle)
  differ from the reference's cull, plus the difference of the counts;
- ``atlas_err``: the largest depth difference over the whole shadow atlas.

A number passes when it is at most its limit (``limits`` in the cell's
workload file). A NaN fails.
"""

from __future__ import annotations

import importlib
import math

import torch

NAMES = ("vis_mismatch", "depth_err", "image_err", "draw_mismatch", "atlas_err")


def frame_numbers(prog: dict, ref: dict) -> dict:
    """vis_mismatch, depth_err and image_err of one frame."""
    tri_p, tri_r = prog["tri_id"], ref["tri_id"]
    same = tri_p == tri_r
    depth = (prog["depth"] - ref["depth"]).abs()
    near_diff = torch.nn.functional.max_pool2d((~same).float()[None, None], 3, stride=1,
                                               padding=1)[0, 0] > 0
    image = (prog["image"] - ref["image"]).abs().amax(dim=-1)
    return {
        "vis_mismatch": float((~same).float().mean()),
        "depth_err": float(torch.where(same, depth, 0.0).max()),
        "image_err": float(torch.where(near_diff, 0.0, image).max()),
    }


def draw_mismatch(prog, ref) -> int:
    """Soup slots whose (valid, instance, triangle) differ, plus |count
    difference|. ``prog`` is the renderer's draw list (owner, tri_idx,
    valid, count), ``ref`` the reference's (instance, tri_idx, valid,
    count)."""
    owner, tri, valid, count = prog
    r_owner, r_tri, r_valid, r_count = ref
    diff = (valid != r_valid) | (valid & ((owner != r_owner) | (tri != r_tri)))
    return int(diff.sum()) + abs(int(count) - int(r_count))


def reference_numbers(reference, frames, first: int, last: int, compared: dict, final: dict,
                      precision: str = "float32") -> dict:
    """The configuration's reference module's frames at each frame of
    ``compared`` ({k: the program's outputs}) against them, and at ``last``
    also its cull and whole atlas against ``final`` (the program's state
    after the window). Returns {frame: its numbers}."""
    refs, atlas = reference.outputs(frames, first, last, set(compared), precision)
    per_frame = {}
    for k in sorted(compared):
        nums = frame_numbers(compared[k], refs[k])
        if k == last:
            nums["draw_mismatch"] = float(draw_mismatch(final["draw_list"], refs[k]["draw_list"]))
            nums["atlas_err"] = float((final["atlas"] - atlas).abs().max())
        per_frame[k] = nums
    return per_frame


def reference_module(cfg: dict):
    """The configuration's plain reference: ``benchmark/reference/<cfg
    "reference">.py``, with ``Frames`` and ``outputs``."""
    return importlib.import_module(f"benchmark.reference.{cfg['reference']}")


def worst(per_frame: dict) -> dict:
    """Each number's worst reading over the compared frames (NaN if any)."""
    out = {}
    for nums in per_frame.values():
        for n, v in nums.items():
            w = out.get(n, 0.0)
            out[n] = w if math.isnan(w) else (v if math.isnan(v) else max(w, v))
    return out


def failed(per_frame: dict, limits: dict) -> int:
    """Compared frames with a number over its limit (or NaN)."""
    return sum(any(not v <= limits[n] for n, v in nums.items()) for nums in per_frame.values())


def verdict(numbers: dict, limits: dict) -> tuple:
    """(every number within its limit, {name: {"value", "limit"}})."""
    table, ok = {}, True
    for n in NAMES:
        v, lim = numbers.get(n, math.nan), limits[n]
        table[n] = {"value": v, "limit": lim}
        ok = ok and not math.isnan(v) and v <= lim
    return ok, table
