"""The system under test as the benchmark drives it: the port's replayed
``Renderer.render`` in a closed loop of frames, at most ``in_flight``
frames ahead of the host (``cell.IN_FLIGHT``).

This module is the only one of the harness that imports the port
(``renderer_tpu_torch``); it takes from it the scene builders, the
``PipelineConfig``, the ``Renderer`` and the ``Camera`` tuple, and hands
it only the inputs the traffic made.
"""

from __future__ import annotations

import time

import numpy as np
import torch


def port():
    """The port's entry points, imported on first use."""
    from renderer_tpu_torch import models
    from renderer_tpu_torch.mathx.camera import Camera
    from renderer_tpu_torch.passes.pipeline import PipelineConfig
    from renderer_tpu_torch.runtime import Renderer
    from renderer_tpu_torch.scene import SceneLimits
    return models, Camera, PipelineConfig, Renderer, SceneLimits


def build_scene(cfg: dict, seed: int, device):
    """The configuration's scene from the seed: ``scene.builder`` of the
    port's ``models`` with ``n_instances`` and ``limits``, its light table
    replaced by ``scene.lights``'s builder when given."""
    models, _, _, _, SceneLimits = port()
    sc = cfg["scene"]
    limits = SceneLimits(**sc["limits"]) if sc.get("limits") else None
    scene = getattr(models, sc["builder"])(sc["n_instances"], seed=seed, limits=limits,
                                           device=device)
    if sc.get("lights"):
        lt = sc["lights"]
        scene = scene._replace(lights=getattr(models, lt["builder"])(lt["n"], device=device))
    return scene


def pipeline_config(cfg: dict):
    _, _, PipelineConfig, _, _ = port()
    kw = dict(cfg["pipeline"])
    if "background" in kw:
        kw["background"] = tuple(kw["background"])
    return PipelineConfig(**kw)


def make_renderer(scene, cfg: dict, device, replay=None):
    _, _, _, Renderer, _ = port()
    r = Renderer(scene, pipeline_config(cfg), outputs=("image", "vis"), device=device,
                 replay=replay)
    r.set_config(**cfg.get("switches", {}))
    r.apply_config_now()
    return r


class Frames:
    """Per table row, the camera and the scene (None: the renderer's own) the
    program renders, every column the traffic moves replaced by its row of
    the device tables; built once before any frame."""

    def __init__(self, scene, tables: dict, traffic):
        from benchmark.harness.traffic import replace_field

        _, Camera, _, _, _ = port()
        pose = tables["pose"]
        tail = [pose[0, i] for i in range(7, 11)]  # fov, aspect, near, far: one tensor each
        self.traffic = traffic
        self.cameras = [Camera(pose[r, 0:3], pose[r, 3:7], *tail) for r in range(pose.shape[0])]
        self.scenes = []
        for r in range(pose.shape[0]):
            sc = None
            for field, table in tables.items():
                if field != "pose":
                    sc = replace_field(sc or scene, field, table[r])
            self.scenes.append(sc)

    def at(self, k: int):
        r = self.traffic.row(k)
        return self.cameras[r], self.scenes[r]


class Clock:
    """Completion marks of frames: CUDA events on the card; on the CPU (the
    tests) the host clock after each frame, the CPU's work being done when
    its call returns."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"

    def mark(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def wait(self, mark) -> None:
        if self.cuda:
            mark.synchronize()

    def between_ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3


def run_frames(renderer, frames: Frames, ks, clock: Clock, in_flight: int, keep=(),
               seconds: float = None, on_frame=None, marks_out=None) -> dict:
    """Render frames k of ``ks`` back to back, waiting before frame k only on
    frame k - in_flight's completion; stop once ``seconds`` have passed on
    the host clock (None: after every k). Returns the frames' completion
    marks, the window's wall seconds (first submission to last completion),
    the start mark, the host seconds of each ``render`` call, the outputs of
    the frames in ``keep`` and of the last frame. ``on_frame(i, k)`` runs
    before the i-th submission; ``marks_out["marks"]`` is the growing list
    of marks."""
    keep = set(keep)
    marks, calls, kept = [], [], {}
    if marks_out is not None:
        marks_out["marks"] = marks
    start = clock.mark()
    t0 = time.perf_counter()
    out, k = None, None
    for i, k in enumerate(ks):
        if i >= in_flight:
            clock.wait(marks[i - in_flight])
        if on_frame is not None:
            on_frame(i, k)
        c0 = time.perf_counter()
        cam, scene = frames.at(k)
        out = renderer.render(cam, scene=scene)
        calls.append(time.perf_counter() - c0)
        marks.append(clock.mark())
        if k in keep:
            kept[k] = out
        if seconds is not None and time.perf_counter() - t0 >= seconds:
            break
    if marks:
        clock.wait(marks[-1])
    wall = time.perf_counter() - t0
    return {"marks": marks, "start": start, "wall_s": wall, "calls_s": calls, "kept": kept,
            "last": (k, out), "frames": len(marks)}


def units_per_frame(renderer, frames: Frames, ks) -> list:
    """Atlas units re-rendered each frame: the units whose signature in
    ``state["shadow_cache"]`` changed (the count ``bench_torch.py`` makes),
    one frame at a time."""
    sig_prev = renderer.state["shadow_cache"][1].clone()
    out = []
    for k in ks:
        cam, scene = frames.at(k)
        renderer.render(cam, scene=scene)
        sig = renderer.state["shadow_cache"][1]
        changed = ~((sig == sig_prev) | (torch.isnan(sig) & torch.isnan(sig_prev)))
        out.append(int(changed.reshape(-1, sig.shape[-1]).any(dim=-1).sum()))
        sig_prev = sig.clone()
    return out


def host_array(t) -> np.ndarray:
    return t.detach().cpu().numpy()
