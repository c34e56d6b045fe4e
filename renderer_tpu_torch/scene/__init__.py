"""Scene substrate: fixed-capacity structure-of-arrays tables as torch
tensors on one device (``renderer_tpu.scene``)."""

from renderer_tpu_torch.scene.builder import HostMesh, SceneBuilder  # noqa: F401
from renderer_tpu_torch.scene.types import (  # noqa: F401
    Instances,
    Lights,
    Materials,
    MeshLibrary,
    Scene,
    SceneLimits,
    scene_from_numpy,
)
