"""Checkpoint and resume of scenes and renderer state
(``renderer_tpu.runtime.checkpoint``).

A tree of tensors (the scene, streamed-in content included; the
renderer's persistent state) saves as a flat .npz of its leaves
(``utils.tree``) and loads into the structure of a tree of the same shapes
and dtypes, each leaf back on that tree's device (or a given one). The
runtime switches and the frame count go to a JSON file beside them.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from renderer_tpu_torch.utils import tree as tree_util


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def save_pytree(path: str, tree) -> None:
    leaves = tree_util.leaves(tree)
    np.savez_compressed(path, **{f"leaf_{i}": _numpy(x) for i, x in enumerate(leaves)})


def load_pytree(path: str, like, device=None):
    """Load into the structure of ``like`` (shapes and dtypes must match);
    a tensor leaf goes to ``device``, or to the device of ``like``'s leaf
    when None."""
    leaves, structure = tree_util.flatten(like)
    new = []
    with np.load(path) as data:
        for i, ref in enumerate(leaves):
            arr = data[f"leaf_{i}"]
            is_tensor = isinstance(ref, torch.Tensor)
            shape = tuple(ref.shape) if is_tensor else np.shape(ref)
            dtype = (torch.empty(0, dtype=ref.dtype).numpy().dtype if is_tensor
                     else np.asarray(ref).dtype)
            if tuple(arr.shape) != shape:
                raise ValueError(f"checkpoint leaf {i} shape {arr.shape} != expected {shape}")
            if arr.dtype != dtype:
                raise ValueError(f"checkpoint leaf {i} dtype {arr.dtype} != expected {dtype}")
            if is_tensor:
                new.append(torch.from_numpy(arr).to(device or ref.device))
            else:
                new.append(arr)
    return tree_util.unflatten(structure, new)


def save_renderer(path_prefix: str, renderer) -> None:
    """Write <prefix>.scene.npz, <prefix>.state.npz and <prefix>.meta.json."""
    save_pytree(path_prefix + ".scene.npz", renderer.scene)
    save_pytree(path_prefix + ".state.npz", renderer.state)
    with open(path_prefix + ".meta.json", "w") as f:
        json.dump({"frame_number": renderer.stats["frames"],
                   "config": dataclasses.asdict(renderer.config)}, f)


def load_renderer(path_prefix: str, renderer) -> None:
    """Restore scene, state, frame count and switches into an existing,
    compatible Renderer, on its device."""
    renderer.scene = load_pytree(path_prefix + ".scene.npz", renderer.scene, renderer.device)
    renderer.state = load_pytree(path_prefix + ".state.npz", renderer.state, renderer.device)
    with open(path_prefix + ".meta.json") as f:
        meta = json.load(f)
    renderer.stats["frames"] = meta["frame_number"]
    renderer.config = dataclasses.replace(renderer.config, **meta["config"])
    renderer._pending_config = dataclasses.replace(renderer.config)
