"""Frame runtime (``renderer_tpu.runtime``)."""

from renderer_tpu_torch.runtime.frame import Renderer, execute_plan  # noqa: F401
