"""Scene families (``renderer_tpu.models``)."""

from renderer_tpu_torch.models.scenes import (  # noqa: F401
    box_scene,
    city_scene,
    colonnade_scene,
    make_skinned_arm,
    shadow_envelope_lights,
    skinned_scene,
    sponza_like_scene,
    textured_scene,
)
