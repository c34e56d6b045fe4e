"""The port's scene builders against the JAX package's: the same arguments
give the same tables, array for array and bit for bit (the JAX atlas's quad
tables are not part of the port's scene; its skins are)."""

import pytest
import torch

from renderer_tpu.models import sponza_like_scene as jax_sponza, textured_scene as jax_textured
from renderer_tpu.scene import SceneLimits as JaxLimits
from renderer_tpu.scene.types import as_numpy_scene
from renderer_tpu_torch.models import sponza_like_scene, textured_scene
from renderer_tpu_torch.scene import SceneLimits, scene_from_numpy


def assert_scenes_equal(got, want):
    for part in got._fields:
        g, w = getattr(got, part), getattr(want, part)
        for f in g._fields:
            a, b = getattr(g, f), getattr(w, f)
            if a is None or b is None:
                assert a is None and b is None, (part, f)
                continue
            assert a.dtype == b.dtype and a.shape == b.shape, (part, f, a.dtype, b.dtype)
            assert torch.equal(a, b), (part, f)


@pytest.mark.parametrize("which", ["textured_tiny", "sponza_200"])
def test_port_scene_equals_jax_scene(which):
    if which == "textured_tiny":
        got = textured_scene(SceneLimits.tiny(), 32, device="cpu")
        want = jax_textured(JaxLimits.tiny(), 32)
    else:
        got = sponza_like_scene(200, device="cpu")
        want = jax_sponza(200)
    assert_scenes_equal(got, scene_from_numpy(as_numpy_scene(want), device="cpu"))
    assert got.meshes.tri_rec is not None
    assert got.atlas.packed_u32.dtype == torch.int32  # the uint32 bits


def test_scene_on_requested_device():
    scene = textured_scene(SceneLimits.tiny(), 32, device="meta")
    assert scene.meshes.positions.device.type == "meta"
    assert scene.atlas.packed_u32.device.type == "meta"


def test_builder_capacity_errors():
    from renderer_tpu_torch.scene import SceneBuilder, primitives

    b = SceneBuilder(SceneLimits.tiny())
    mesh = b.add_mesh(primitives.box())
    for _ in range(SceneLimits.tiny().max_instances):
        b.add_instance(mesh)
    with pytest.raises(ValueError, match="instance table full"):
        b.add_instance(mesh)
    b = SceneBuilder(SceneLimits.tiny())
    b.add_mesh(primitives.uv_sphere(rings=48, sectors=96))  # > 4096 triangles
    with pytest.raises(ValueError, match="capacity exceeded"):
        b.build(device="cpu")
