"""Projectiles: spawn and despawn churn in a reserved instance-slot range
(``renderer_tpu.runtime.gameplay``).

One step integrates motion under gravity, expires slots by age or height
(the alive mask's churn), and spawns into the first dead slot, writing the
scene's instance tensors in place. The step reads nothing on the host:
the first dead slot is an ``argmin`` over ``alive`` and the spawn a
``torch.where``; ``alive_count()`` is the only host read, between frames.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from renderer_tpu_torch.scene.types import Scene

GRAVITY = -9.8


class ProjectileState(NamedTuple):
    velocity: torch.Tensor  # (K, 3)
    age: torch.Tensor       # (K,)

    @staticmethod
    def init(capacity: int, device) -> "ProjectileState":
        return ProjectileState(velocity=torch.zeros((capacity, 3), device=device),
                               age=torch.zeros((capacity,), device=device))


def projectile_step(scene: Scene, state: ProjectileState, base: int, capacity: int, dt: float,
                    ttl: float, spawn_pos, spawn_vel, do_spawn: bool) -> None:
    """One tick, in place on ``scene.instances`` and ``state``: integrate,
    expire, then spawn at most one projectile (at ``spawn_pos`` with
    ``spawn_vel``, both host triples) when ``do_spawn`` and a slot is
    dead."""
    inst = scene.instances
    sl = slice(base, base + capacity)
    alive = inst.alive[sl]
    vel = state.velocity.clone()
    vel[:, 1] += alive * float(np.float32(GRAVITY) * np.float32(dt))  # float32, as JAX
    pos = torch.where(alive[:, None], inst.translation[sl] + vel * dt, inst.translation[sl])
    age = torch.where(alive, state.age + dt, state.age)

    # expire: dead slots are masked out of culling
    alive = alive & ~((age > ttl) | (pos[:, 1] < -50.0))
    if do_spawn:
        slot = torch.arange(capacity, device=alive.device) == alive.to(torch.uint8).argmin()
        slot &= ~alive.all()
        alive = alive | slot
        for i in range(3):
            pos[:, i] = torch.where(slot, float(spawn_pos[i]), pos[:, i])
            vel[:, i] = torch.where(slot, float(spawn_vel[i]), vel[:, i])
        age = torch.where(slot, 0.0, age)
    inst.alive[sl] = alive
    inst.translation[sl] = pos
    inst.count.clamp_(min=base + capacity)
    state.velocity.copy_(vel)
    state.age.copy_(age)


class ProjectileSystem:
    """A reserved range of ``capacity`` instance slots after the scene's
    live ones, drawn with ``mesh_id`` and ``material_id`` at scale 0.15."""

    def __init__(self, scene: Scene, mesh_id: int, material_id: int, capacity: int = 32):
        self.scene = scene
        self.base = int(scene.instances.count)  # a host read, at set-up
        self.capacity = capacity
        inst = scene.instances
        if self.base + capacity > inst.mesh_id.shape[0]:
            raise ValueError("instance table too small for projectile slots")
        sl = slice(self.base, self.base + capacity)
        inst.mesh_id[sl].fill_(mesh_id)
        inst.material_id[sl].fill_(material_id)
        inst.scale[sl].fill_(0.15)
        self.state = ProjectileState.init(capacity, inst.alive.device)

    def step(self, dt=1 / 60, ttl=3.0, spawn_pos=(0, 1, 0), spawn_vel=(2, 4, 0),
             spawn=True) -> Scene:
        projectile_step(self.scene, self.state, self.base, self.capacity, dt, ttl, spawn_pos,
                        spawn_vel, spawn)
        return self.scene

    def alive_count(self) -> int:
        """Live projectiles: reads the card, so call it between frames."""
        return int(self.scene.instances.alive[self.base:self.base + self.capacity].sum())
