"""Frame runtime (``renderer_tpu.runtime``): the Renderer and its plan
executor, auto-capacity and kernel live-reload; streaming, the staging
arena, checkpoints, projectiles and the camera controller in their
modules."""

from renderer_tpu_torch.runtime.autocap import AutoCapacityRenderer  # noqa: F401
from renderer_tpu_torch.runtime.frame import Renderer, RuntimeConfig, execute_plan  # noqa: F401
from renderer_tpu_torch.runtime.reload import KernelReloader  # noqa: F401
