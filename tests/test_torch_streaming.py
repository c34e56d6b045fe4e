"""The port's scene streamer (renderer_tpu_torch/runtime/streaming.py)
against the JAX package's, on the streaming cases of
tests/test_runtime_aux.py: the per-frame budget, a mesh chunked past
CHUNK_VERTS through the staging arena, the capacity guard, texture
streaming and texture-layer recycling.

The same requests and pumps go through both streamers (decodes waited for
before each pump, so both integrate the same items). Gates, with their
reasons:
- after every pump, every table of the port's scene equal to the JAX
  scene's, bit for bit (copies and gathers), except cluster_data, float
  math on both sides (XLA and torch sum in other orders), within 1e-6;
  its cone sine is sqrt(1 - cos^2) of the cosine, so it is held to the
  cosine's 1e-6 carried through the root (1e-6 * cos / sin: a one-ulp
  cosine at cos 0.9994 moves the sine by 1.4e-6), and a degenerate cone
  (never culled: cos -1, sin 2 in both) keeps the direction of a
  near-zero normal sum, not compared;
- the stats (uploaded, chunks), the MemoryErrors, the layer ids handed
  out and recycled, and the arena's live blocks after each pump (frees
  deferred two pumps) equal to JAX's;
- the streamed scene's frame against the JAX Renderer's (its Pallas
  raster in interpret mode): the visible (instance, library triangle) equal on >= 99.9% of pixels
  and display-clamped PSNR >= 50 dB.
"""

import time

import jax.numpy as jnp
import numpy as np
import pytest

from renderer_tpu.mathx.camera import Camera as JaxCamera
from renderer_tpu.passes.pipeline import PipelineConfig as JaxConfig
from renderer_tpu.runtime import Renderer as JaxRenderer
from renderer_tpu.runtime.allocator import Arena as JaxArena
from renderer_tpu.runtime.streaming import SceneStreamer as JaxStreamer
from renderer_tpu.scene import SceneBuilder as JaxBuilder, SceneLimits as JaxLimits
from renderer_tpu.scene import primitives as jprim
from renderer_tpu.utils.image import psnr
from renderer_tpu_torch.mathx import Camera
from renderer_tpu_torch.passes.pipeline import PipelineConfig
from renderer_tpu_torch.runtime import Renderer
from renderer_tpu_torch.runtime.allocator import Arena
from renderer_tpu_torch.runtime.streaming import CHUNK_VERTS, SceneStreamer
from renderer_tpu_torch.scene import SceneBuilder, SceneLimits, primitives
from test_torch_gltf import assert_scene_tables_equal
from test_torch_pipeline import visible_identity

CLUSTER_ATOL = 1e-6
W, H = 128, 64


def both_scenes(atlas_size=256, texture_slots=None, plane=False, **limits):
    """The same base scene from both builders (tiny limits but ``limits``):
    a box (or a plane with a material on layer 0) and a light."""
    out = []
    for builder, lim in ((SceneBuilder, SceneLimits), (JaxBuilder, JaxLimits)):
        b = builder(lim.tiny()._replace(**limits), atlas_size=atlas_size)
        if plane:
            m = b.add_mesh(primitives.plane(size=8.0))
            b.add_instance(m, b.add_material(base_color=(1, 1, 1, 1), roughness=1.0,
                                             base_color_tex=0))
            b.add_light(position=(0, -1, 0), directional=True, intensity=3.0)
        else:
            m = b.add_mesh(primitives.box())
            b.add_instance(m, b.add_material(base_color=(0.7, 0.7, 0.7, 1)))
            b.add_light(position=(2, 3, 4), intensity=20.0)
        kw = {} if texture_slots is None else {"texture_slots": texture_slots}
        out.append(b.build(device="cpu", **kw) if builder is SceneBuilder else b.build(**kw))
    return out


def wait(*streamers):
    deadline = time.time() + 60.0
    while time.time() < deadline and not all(f.done() for s in streamers for f in s._pending):
        time.sleep(0.01)


def pump_both(port, jax):
    wait(port, jax)
    got = port.pump()
    jax.pump()
    assert_scene_tables_equal(got, jax.scene, cluster_atol=CLUSTER_ATOL)
    assert port.stats == jax.stats
    return got


def frames_agree(port_scene, jax_scene, pos, capacity=1024, **cam):
    """The port's 128x64 frame against the JAX Renderer's (its Pallas raster
    in interpret mode, whose edge rule the port's raster follows)."""
    outputs = ("image", "vis", "soup")
    cam = dict(aspect=W / H, **cam)
    got = Renderer(port_scene, PipelineConfig(width=W, height=H, tri_capacity=capacity),
                   outputs=outputs).render(Camera.create(pos, device="cpu", **cam))
    jcfg = JaxConfig(width=W, height=H, tri_capacity=capacity, use_pallas=True,
                     pallas_interpret=True)
    want = JaxRenderer(jax_scene, jcfg, outputs=outputs).render(
        JaxCamera.create(position=jnp.asarray(pos), **cam))
    got_id, want_id = got["vis"].tri_id.numpy(), np.asarray(want["vis"].tri_id)
    same = visible_identity(got, got_id) == visible_identity(want, want_id)
    assert same.mean() >= 0.999, f"visible triangle differs on {(~same).sum()} pixels"
    img = got["image"].numpy()
    assert psnr(np.clip(img, 0, 1), np.clip(np.asarray(want["image"]), 0, 1)) >= 50.0
    return img, got_id


def test_streaming_budget_and_render():
    port_scene, jax_scene = both_scenes()
    port, jax = SceneStreamer(port_scene, budget=3), JaxStreamer(jax_scene, budget=3)
    for i in range(7):
        for s, prim in ((port, primitives), (jax, jprim)):  # each package's HostMesh
            s.request_mesh(prim.uv_sphere(rings=4, sectors=6), material_id=0,
                           translation=(i - 3.0, 0.0, -1.0), scale=0.4)
    for uploaded in (3, 6, 7):
        scene = pump_both(port, jax)
        assert port.stats["uploaded"] == uploaded
    assert int(scene.meshes.mesh_count) == 8 and int(scene.instances.count) == 8
    assert scene is port_scene  # written in place
    _, tri = frames_agree(scene, jax.scene, [0.0, 0.8, 4.0], near=0.1, far=50.0)
    assert (tri >= 0).mean() > 0.02  # the streamed meshes are in view
    port.close()
    jax.close()


def test_streaming_large_mesh_chunked_through_the_arena():
    port_scene, jax_scene = both_scenes(max_vertices=16384, max_triangles=16384)
    arenas = Arena(16 << 20, device="cpu"), JaxArena(16 << 20)
    port = SceneStreamer(port_scene, budget=8, arena=arenas[0])
    jax = JaxStreamer(jax_scene, budget=8, arena=arenas[1])
    big = primitives.uv_sphere(rings=64, sectors=96)
    assert len(big.positions) > CHUNK_VERTS
    port.request_mesh(big, translation=(0, 0, -1.0), scale=0.8)
    jax.request_mesh(jprim.uv_sphere(rings=64, sectors=96), translation=(0, 0, -1.0), scale=0.8)
    scene = pump_both(port, jax)
    assert port.stats["uploaded"] == 1 and port.stats["chunks"] >= 2
    lib = scene.meshes
    off, n_v = int(lib.mesh_vertex_offset[1]), len(big.positions)
    assert int(lib.mesh_vertex_count[1]) == n_v and int(lib.lod_tri_count[1, 0]) == len(big.indices)
    assert np.array_equal(lib.positions[off:off + n_v].numpy(), big.positions)
    live = [arenas[0].stats()["live_allocs"]]
    assert live[0] > 0 and live[0] == arenas[1].stats()["live_allocs"]
    for _ in range(2):  # staging freed two pumps after its upload, as in JAX
        pump_both(port, jax)
        live.append(arenas[0].stats()["live_allocs"])
        assert live[-1] == arenas[1].stats()["live_allocs"]
    assert live[1] > 0 and live[2] == 0
    _, tri = frames_agree(scene, jax.scene, [0.0, 0.8, 4.0], capacity=8192, near=0.1, far=50.0)
    assert (tri >= 0).mean() > 0.02  # the streamed meshes are in view
    for s, a in zip((port, jax), arenas):
        s.close()
        assert a.stats()["live_allocs"] == 0
        a.close()


def test_streaming_capacity_guard():
    """Exhausting the mesh library raises MemoryError in both, after the
    same uploads, which left the same tables."""
    port_scene, jax_scene = both_scenes()
    streamers = SceneStreamer(port_scene, budget=8), JaxStreamer(jax_scene, budget=8)
    uploads = []
    for s, prim in zip(streamers, (primitives, jprim)):
        n = 0
        with pytest.raises(MemoryError, match="capacity exhausted"):
            while n < 10_000:
                s._upload(prim.uv_sphere(rings=12, sectors=16), 0, (0, 0, 0), (1, 0, 0, 0), 1.0)
                n += 1
        assert s._v_off <= s.scene.meshes.positions.shape[0]
        uploads.append((n, s._v_off, s._t_off))
        s.close()
    assert uploads[0] == uploads[1] and uploads[0][0] > 0
    assert_scene_tables_equal(streamers[0].scene, streamers[1].scene, cluster_atol=CLUSTER_ATOL)


def test_texture_streaming():
    """A red 8x8 texture into the placeholder layer 0 (white until it
    lands), and a 20x12 image resized to the layer size as Pillow does it."""
    port_scene, jax_scene = both_scenes(atlas_size=8, texture_slots=2, plane=True)
    port, jax = SceneStreamer(port_scene, budget=2), JaxStreamer(jax_scene, budget=2)
    # looking down from off the plane's diagonal: from straight above it,
    # pixel centres lie on the two triangles' shared edge, where one ulp of
    # the camera matrices decides the triangle
    cam = dict(rotation=(0.70710677, -0.70710677, 0.0, 0.0), near=0.1, far=50.0)
    before, _ = frames_agree(port.scene, jax.scene, [0.3, 2.0, 0.2], capacity=256, **cam)
    red = np.zeros((8, 8, 4), np.uint8)
    red[..., 0] = red[..., 3] = 255
    odd = np.random.default_rng(4).integers(0, 256, (12, 20, 4), dtype=np.uint8)
    assert [port.request_texture(red), port.request_texture(odd)] == [
        jax.request_texture(red), jax.request_texture(odd)]
    scene = pump_both(port, jax)
    after, _ = frames_agree(scene, jax.scene, [0.3, 2.0, 0.2], capacity=256, **cam)
    c0, c1 = before[H // 2, W // 2], after[H // 2, W // 2]
    assert c0[1] > 0.1 and abs(c0[0] - c0[1]) < 0.05  # white placeholder
    assert c1[0] > 0.1 and c1[1] < 0.05 * c1[0] + 0.02  # red
    port.close()
    jax.close()


def test_texture_layer_recycling():
    port_scene, jax_scene = both_scenes(atlas_size=8, texture_slots=2, plane=True)
    img = np.zeros((8, 8, 4), np.uint8)
    handed = []
    for s in (SceneStreamer(port_scene, budget=4), JaxStreamer(jax_scene, budget=4)):
        ids = [s.request_texture(img), s.request_texture(img)]
        with pytest.raises(MemoryError, match="release_texture"):
            s.request_texture(img)
        s.release_texture(ids[0])
        ids.append(s.request_texture(img))  # recycled
        with pytest.raises(ValueError):
            s.release_texture(999)
        s.release_texture(ids[1])
        with pytest.raises(ValueError, match="already released"):
            s.release_texture(ids[1])
        handed.append(ids)
        s.close()
    assert handed[0] == handed[1] and handed[0][2] == handed[0][0]
