"""Automatic triangle-capacity budgeting (``renderer_tpu.runtime.autocap``).

``AutoCapacityRenderer`` keeps a ladder of capacity tiers, one Renderer
each (made on first use and kept), and every ``check_every`` frames reads
two scalars on the host: the expansion demand of the visible set
(``geometry.expansion_demand``: what the cull would expand, whatever the
capacity) and the last cull's draw-list count. Then it re-plans:

- UP one tier when either crowds its ceiling (demand > up_frac x the
  expansion capacity, or count > up_frac x tri_capacity; the count alone
  is no truncation signal, since the expansion clamps upstream of it);
- DOWN when the demand and count would fit the tier below with room to
  spare (< down_frac of its capacities), one tier per check, so a camera
  pan cannot make the tiers thrash.

The two reads block: they wait for the frame just queued. They happen
between frames, once per ``check_every`` frames; the frames in between
make no host read. A tier switch carries the runtime switches and every
state entry whose shapes and dtypes match (vis, prev_vp, the shadow cache);
the draw list is capacity-shaped and starts empty, and the next cull
rewrites it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from renderer_tpu_torch.ops import geometry
from renderer_tpu_torch.passes.pipeline import PipelineConfig
from renderer_tpu_torch.runtime.frame import Renderer
from renderer_tpu_torch.scene.types import Scene
from renderer_tpu_torch.utils import tree


def _shapes_match(a, b) -> bool:
    la, lb = tree.leaves(a), tree.leaves(b)
    return len(la) == len(lb) and all(
        getattr(x, "shape", None) == getattr(y, "shape", None)
        and getattr(x, "dtype", None) == getattr(y, "dtype", None)
        for x, y in zip(la, lb))


class AutoCapacityRenderer:
    """A Renderer facade that picks ``tri_capacity`` from the measured
    frame; ``device`` as for ``Renderer`` (the scene's)."""

    def __init__(
        self,
        scene: Scene,
        cfg: Optional[PipelineConfig] = None,
        # powers of two plus 3*2^k mid-rungs: capacity cost is about linear,
        # so a mid-rung saves about 25% whenever demand lands between octaves
        ladder: Sequence[int] = (
            1 << 14, 1 << 15, 1 << 16, 3 << 15, 1 << 17, 3 << 16,
            1 << 18, 3 << 17, 1 << 19,
        ),
        check_every: int = 8,
        up_frac: float = 0.85,
        down_frac: float = 0.6,
        outputs=("image", "vis"),
        device=None,
    ):
        self.cfg = cfg or PipelineConfig()
        self.ladder = sorted(int(c) for c in ladder)
        if any(c % 256 for c in self.ladder):
            raise ValueError(f"ladder rungs must be multiples of 256: {self.ladder}")
        self.check_every = check_every
        self.up_frac = up_frac
        self.down_frac = down_frac
        self.outputs = tuple(outputs)
        self.device = device
        self.scene = scene
        self._renderers: dict[int, Renderer] = {}
        self._switches: dict = {}
        self._tier = 0  # the smallest tier; the first checks grow it
        self._frames = 0
        self.stats = {"tier_switches": 0, "last_count": 0, "last_demand": 0}

    @property
    def capacity(self) -> int:
        return self.ladder[self._tier]

    @property
    def renderer(self) -> Renderer:
        cap = self.capacity
        if cap not in self._renderers:
            self._renderers[cap] = Renderer(
                self.scene, dataclasses.replace(self.cfg, tri_capacity=cap),
                outputs=self.outputs, device=self.device)
        return self._renderers[cap]

    def set_config(self, **switches) -> None:
        """Runtime switches, taken up at once and carried to every tier."""
        self._switches.update(switches)
        self.renderer.set_config(**switches)
        self.renderer.apply_config_now()

    def _switch_tier(self, new_tier: int) -> None:
        old = self.renderer
        self._tier = new_tier
        new = self.renderer
        if self._switches:
            new.set_config(**self._switches)
        new.apply_config_now()
        carried = dict(new.state)
        for name, val in old.state.items():
            if name in carried and _shapes_match(val, carried[name]):
                carried[name] = val
        new.state = carried
        self.stats["tier_switches"] += 1

    def demand(self, camera) -> int:
        """The expansion demand of the visible set at ``camera`` (a host
        read: blocks until the card has computed it)."""
        prepared = geometry.prepare_frame_columns(self.scene, camera)
        return int(geometry.expansion_demand(self.scene, prepared.visible, prepared.lod))

    def render(self, camera, scene: Optional[Scene] = None, **kw) -> dict:
        if scene is not None:
            self.scene = scene
        out = self.renderer.render(camera, scene=scene, **kw)
        self._frames += 1
        if self._frames % self.check_every == 0:
            demand = self.demand(camera)
            dl = self.renderer.state.get("draw_list")
            count = int(dl.count) if dl is not None else 0
            self.stats["last_count"] = count
            self.stats["last_demand"] = demand
            cap = self.capacity
            if ((demand > self.up_frac * 2 * cap or count > self.up_frac * cap)
                    and self._tier + 1 < len(self.ladder)):
                self._switch_tier(self._tier + 1)
            elif (self._tier > 0
                  and demand < self.down_frac * 2 * self.ladder[self._tier - 1]
                  and count < self.down_frac * self.ladder[self._tier - 1]):
                self._switch_tier(self._tier - 1)
        return out
