"""The device an entry point uses when its caller names none.

The port runs on the CUDA card. An entry point called without ``device=``
puts its tensors there; on a host without CUDA that call raises. The CPU
is used only when the caller asks for it (``device="cpu"``), as the tests
do; nothing falls back to it.
"""

from __future__ import annotations

import torch


def default_device() -> torch.device:
    """The CUDA card, whether or not this host has one."""
    return torch.device("cuda")


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device, or ``default_device()`` when None."""
    return default_device() if device is None else torch.device(device)
