"""The HUD's text (``renderer_tpu.runtime.hud``): the frame count and time,
fps figures, the runtime switches, the active plan's passes, the staging
arena and the streamer, shadow-caster truncation, the cluster budget and
the cached atlas's state, and a check of a frame's outputs. Both read
device values on the host, so they run between frames, never inside one.
(The JAX package's raster bin-overflow line has no counterpart: the
port's bin lists have no cap.)
"""

from __future__ import annotations

import dataclasses
import os
import tempfile

import numpy as np
import torch


def format_hud(renderer, frame_stats=None, arena=None, streamer=None, extra: dict = None,
               prepared=None) -> str:
    """The HUD panel's lines for ``renderer`` (a ``runtime.Renderer``).
    ``frame_stats`` (``utils.profiling.FrameStats``) adds the fps line,
    ``arena`` (``runtime.allocator.Arena``) the staging arena's,
    ``streamer`` (``runtime.streaming.SceneStreamer``) the streaming line;
    ``prepared`` (the last frame's prepare result) adds the shadow-caster
    and cluster-budget lines."""
    lines = ["=== renderer_tpu HUD ===",
             f"frame {renderer.stats['frames']}  plans built: {len(renderer._plans)}"
             f"  last frame: {renderer.stats['last_ms']:.1f} ms"]
    if frame_stats is not None:
        s = frame_stats.summary()
        lines.append(f"fps: {s['fps']:.1f}  avg: {s['ms_avg']:.1f} ms  p99: {s['ms_p99']:.1f} ms")
    cfgd = dataclasses.asdict(renderer.config)
    lines.append("switches: " + "  ".join(f"{k}={'on' if v else 'off'}" for k, v in cfgd.items()))
    lines.append("active passes: " + " -> ".join(p.name for p in renderer.passes))
    if arena is not None:
        a = arena.stats()
        lines.append("staging arena: "
                     f"{a['used']/1e6:.1f}/{a['capacity']/1e6:.1f} MB used, "
                     f"peak {a['peak_used']/1e6:.1f} MB, live allocs {a['live_allocs']}, "
                     f"largest free {a['largest_free_block']/1e6:.1f} MB "
                     f"({a['free_block_count']} blocks)")
    if streamer is not None:
        st = streamer.stats
        lines.append(f"streaming: {st['uploaded']}/{st['requested']} uploaded "
                     f"({st['decoded'] - st['uploaded']} decoded+queued), "
                     f"budget {streamer.budget}/frame")
    cfg = renderer.cfg
    if prepared is not None:
        if renderer.config.shadows:
            from renderer_tpu_torch.ops.shadow import light_matrices_cube, shadow_caster_truncation

            mats = light_matrices_cube(renderer.scene.lights, prepared.scene_min,
                                       prepared.scene_max)
            t = [int(x) for x in shadow_caster_truncation(
                renderer.scene, prepared.model, prepared.lod, mats, cfg.shadow_slots,
                cfg.caster_capacity, slot_size=cfg.shadow_size, scene_min=prepared.scene_min,
                scene_max=prepared.scene_max).tolist()]
            lines.append("shadow casters: " + ("OK" if not any(t) else
                                               f"DROPPED per slot {t} (raise shadow_tri_capacity)"))
        if cfg.cluster_cull and renderer.scene.meshes.cluster_data is not None:
            from renderer_tpu_torch.ops.geometry import cluster_budget_overflow

            ov = int(cluster_budget_overflow(renderer.scene, prepared.visible, prepared.lod,
                                             cfg.expand_capacity))
            lines.append("cluster budget: " + ("OK" if ov == 0 else
                                               f"{ov} clusters OVER (geometry dropped)"))
    if renderer.config.shadows and cfg.shadow_cache:
        sig, cursor = renderer.state["shadow_cache"][1], renderer.state["shadow_cache"][2]
        units = sig.reshape(-1, sig.shape[-1])
        never = int(torch.isnan(units).any(dim=-1).sum())
        lines.append(f"shadow atlas cache: {sig.shape[0]} slots"
                     + (f" x {sig.shape[1]} bands" if sig.dim() == 3 else "")
                     + f", {never} never-rendered units, budget "
                     f"{cfg.shadow_update_budget or 'all-dirty'}/frame, cursor {int(cursor)}")
    for k, v in (extra or {}).items():
        lines.append(f"{k}: {v}")
    return "\n".join(lines)


def validate_frame(outputs: dict, dump_path: str = None) -> None:
    """Raise FloatingPointError when a float tensor among the outputs holds
    a NaN or an infinity, after saving the offending arrays to
    ``dump_path`` (an .npz; by default in the temporary directory)."""
    bad = {}

    def leaves(v):
        if isinstance(v, torch.Tensor):
            yield v
        elif isinstance(v, (list, tuple)):
            for x in v:
                yield from leaves(x)

    for name, value in outputs.items():
        for i, leaf in enumerate(leaves(value)):
            if leaf.is_floating_point() and not bool(torch.isfinite(leaf).all()):
                bad[f"{name}.{i}"] = leaf.detach().cpu().numpy()
    if bad:
        dump_path = dump_path or os.path.join(tempfile.gettempdir(),
                                              "renderer_tpu_torch_crash.npz")
        np.savez(dump_path, **bad)
        raise FloatingPointError(f"non-finite values in frame outputs {sorted(bad)}; "
                                 f"state dumped to {dump_path}")
