"""A cell's configuration cut to a size the CPU tests can run: 64 instances
at 128x64, slots of 128x128 in 2 bands, capacities of 4096."""

import copy


def tiny(cfg: dict) -> dict:
    cfg = copy.deepcopy(cfg)
    cfg["scene"]["n_instances"] = 64
    p = cfg["pipeline"]
    p.update(width=128, height=64, tri_capacity=4096, shadow_size=128, shadow_progressive=2)
    if p.get("shadow_tri_capacity"):
        p["shadow_tri_capacity"] = 4096
    return cfg
