"""The port's glTF loader and writer (renderer_tpu_torch/scene/gltf.py)
against the JAX package's, on the files of tests/test_gltf.py.

Gates, with their reasons:
- every case (write_glb round trips, node hierarchy with a matrix, a skin
  with a LINEAR clip, CUBICSPLINE with two animations, STEP, interleaved
  byteStride views, u8 and u16 indices, a sparse accessor, normalized u16
  uvs, PNG textures) loaded by both loaders into builders that build the
  same tables: every table of the port's scene equal to the JAX scene's,
  bit for bit (the same numpy code; the PNGs decode and resize as Pillow
  does them, ``utils.image``), cluster_data included;
- the interleaved overrun raises ValueError in both;
- both write_glb give the same bytes;
- an image that does not decode gives layer -1 with a warning;
- one loaded scene rendered by both packages at 128x128 (the port's
  raster tiles are 64 pixels wide, so not at test_gltf's 96; the JAX
  package's XLA raster): the visible (instance, library triangle) equal on >= 99.9%
  of pixels and display-clamped PSNR >= 50 dB.
"""

import base64
import io
import json

import jax.numpy as jnp
import numpy as np
import pytest
from PIL import Image

from renderer_tpu.mathx.camera import Camera as JaxCamera
from renderer_tpu.passes.pipeline import PipelineConfig as JaxConfig
from renderer_tpu.runtime import Renderer as JaxRenderer
from renderer_tpu.scene import SceneBuilder as JaxBuilder, SceneLimits as JaxLimits
from renderer_tpu.scene import primitives as jprim
from renderer_tpu.scene.gltf import load_gltf as jax_load, write_glb as jax_write
from renderer_tpu.scene.types import as_numpy_scene
from renderer_tpu.utils.image import psnr
from renderer_tpu_torch.mathx import Camera
from renderer_tpu_torch.passes.pipeline import PipelineConfig
from renderer_tpu_torch.runtime import Renderer
from renderer_tpu_torch.scene import SceneBuilder, SceneLimits, primitives
from renderer_tpu_torch.scene.gltf import load_gltf, write_glb
from renderer_tpu_torch.scene.types import CL_AXIS, CL_COS, CL_SIN
from test_torch_pipeline import visible_identity

Q = (0.9393727, 0.0, 0.34289780, 0.0)  # 0.7 rad about +Y


def assert_scene_tables_equal(port, jax_scene, cluster_atol=0.0):
    """Every table of the port's Scene equal to the JAX scene's (its quad
    tables have no counterpart); cluster_data, when ``cluster_atol``,
    within it, the cone's sine (sqrt(1 - cos^2) of the cosine) within that
    tolerance carried through the square root (atol * cos / sin), and the
    axis of a degenerate cone (never culled) not compared."""
    want = as_numpy_scene(jax_scene)
    for part in ("meshes", "instances", "materials", "lights", "atlas", "skins"):
        p, j = getattr(port, part), getattr(want, part)
        for f in type(p)._fields:
            a, b = getattr(p, f), getattr(j, f)
            assert (a is None) == (b is None), f"{part}.{f}"
            if a is None:
                continue
            a = a.cpu().numpy()
            if f == "packed_u32":
                a = a.view(np.uint32)
            b = np.asarray(b)
            assert a.shape == b.shape and a.dtype == b.dtype, (part, f, a.dtype, b.dtype)
            if f == "cluster_data" and cluster_atol:
                # the cone's sine is sqrt(1 - cos^2) of its cosine: a cosine
                # within atol moves it by up to atol * cos / sin
                tol = np.full(b.shape, cluster_atol, np.float64)
                cos, sin = b[:, CL_COS].astype(np.float64), b[:, CL_SIN].astype(np.float64)
                tol[:, CL_SIN] *= np.maximum(1.0, np.abs(cos) / np.maximum(sin, 1e-12))
                # a degenerate cone (cos -1, sin 2: never culled) keeps the
                # direction of a near-zero normal sum, which no test reads
                degenerate = (b[:, CL_COS] == -1.0) & (b[:, CL_SIN] == 2.0)
                assert np.array_equal(degenerate, (a[:, CL_COS] == -1.0) & (a[:, CL_SIN] == 2.0))
                tol[degenerate, CL_AXIS:CL_AXIS + 3] = np.inf
                bad = np.abs(a.astype(np.float64) - b) > tol
                assert not bad.any(), f"cluster_data differs at {np.argwhere(bad)[:5].tolist()}"
            else:
                assert np.array_equal(a, b), f"{part}.{f}"


def _doc(arrays, accessors, mesh_prims, views=None, **extra):
    """A glTF document with ``arrays`` packed into one data-URI buffer, one
    tight bufferView each unless ``views`` is given."""
    blob = b"".join(np.ascontiguousarray(a).tobytes() for a in arrays)
    if views is None:
        offs = np.cumsum([0] + [a.nbytes for a in arrays[:-1]])
        views = [{"buffer": 0, "byteOffset": int(o), "byteLength": int(a.nbytes)}
                 for o, a in zip(offs, arrays)]
    doc = {
        "asset": {"version": "2.0"},
        "buffers": [{"byteLength": len(blob), "uri": "data:application/octet-stream;base64,"
                     + base64.b64encode(blob).decode()}],
        "bufferViews": views, "accessors": accessors,
        "meshes": [{"primitives": mesh_prims}],
        "nodes": [{"mesh": 0}], "scenes": [{"nodes": [0]}], "scene": 0,
    }
    doc.update(extra)
    return doc


def _acc(view, comp, count, typ, **kw):
    return {"bufferView": view, "componentType": comp, "count": count, "type": typ, **kw}


def _box():
    box = primitives.box()
    return box.positions.astype(np.float32), box.indices.astype(np.uint32).reshape(-1, 1), box


def _skin_doc(anim_arrays, samplers):
    """A one-triangle mesh skinned to one joint with the given samplers."""
    pos = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    idx = np.array([0, 1, 2], np.uint32)
    joints = np.array([[0, 0, 0, 0]] * 3, np.uint16)
    weights = np.array([[1, 0, 0, 0]] * 3, np.float32)
    arrays = (pos, idx, joints, weights, *anim_arrays)
    acc = [_acc(0, 5126, 3, "VEC3", min=pos.min(0).tolist(), max=pos.max(0).tolist()),
           _acc(1, 5125, 3, "SCALAR"), _acc(2, 5123, 3, "VEC4"), _acc(3, 5126, 3, "VEC4")]
    acc += [_acc(4 + i, 5126, len(a), "SCALAR" if a.ndim == 1 else "VEC3")
            for i, a in enumerate(anim_arrays)]
    anims = [{"channels": [{"sampler": 0, "target": {"node": 1, "path": "translation"}}],
              "samplers": [s]} for s in samplers]
    return _doc(arrays, acc, [{"attributes": {"POSITION": 0, "JOINTS_0": 2, "WEIGHTS_0": 3},
                               "indices": 1}],
                skins=[{"joints": [1]}], nodes=[{"mesh": 0, "skin": 0}, {}],
                animations=anims, scenes=[{"nodes": [0, 1]}])


def _png(img) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return buf.getvalue()


def case_roundtrip_geometry(path, writer, prim):
    writer(path + ".glb", [prim.uv_sphere(rings=6, sectors=8)])
    return path + ".glb"


def case_roundtrip_instances_and_materials(path, writer, prim):
    writer(path + ".glb", [prim.box()], instances=[(0, 0, (1.0, 2.0, 3.0), Q, 2.0)],
           materials=[dict(base_color=(0.8, 0.1, 0.2, 1.0), metallic=0.3, roughness=0.6)])
    return path + ".glb"


def case_loaded_scene(path, writer, prim):
    writer(path + ".glb", [prim.box(), prim.uv_sphere(rings=6, sectors=8)],
           instances=[(0, 0, (-0.8, 0, 0), (1, 0, 0, 0), 1.0),
                      (1, 1, (0.8, 0, 0), (1, 0, 0, 0), 1.0)],
           materials=[dict(base_color=(1, 0, 0, 1)), dict(base_color=(0, 0, 1, 1))])
    return path + ".glb"


def case_node_hierarchy_and_matrix(path, *_):
    pos, idx, _ = _box()
    doc = _doc((pos, idx), [_acc(0, 5126, len(pos), "VEC3", min=pos.min(0).tolist(),
                                 max=pos.max(0).tolist()), _acc(1, 5125, len(idx), "SCALAR")],
               [{"attributes": {"POSITION": 0}, "indices": 1}],
               nodes=[{"children": [1], "translation": [5, 0, 0]},
                      {"mesh": 0, "matrix": [2, 0, 0, 0, 0, 2, 0, 0, 0, 0, 2, 0, 0, 1, 0, 1]}])
    return _write(path + ".gltf", doc)


def case_skinned(path, *_):
    pos = np.array([[-0.1, 0, 0], [0.1, 0, 0], [-0.1, 1, 0], [0.1, 1, 0], [-0.1, 2, 0],
                    [0.1, 2, 0]], np.float32)
    idx = np.array([[0, 1, 2], [1, 3, 2], [2, 3, 4], [3, 5, 4]], np.uint32)
    joints = np.array([[0, 0, 0, 0]] * 2 + [[1, 0, 0, 0]] * 4, np.uint16)
    weights = np.array([[1, 0, 0, 0]] * 6, np.float32)
    ibm = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    ibm[1, 1, 3] = -1.0
    times = np.array([0.0, 1.0], np.float32)
    rots = np.array([[0, 0, 0, 1], [0, 0, np.sin(np.pi / 4), np.cos(np.pi / 4)]], np.float32)
    arrays = (pos, idx, joints, weights, np.ascontiguousarray(ibm.transpose(0, 2, 1)), times, rots)
    acc = [_acc(0, 5126, 6, "VEC3", min=pos.min(0).tolist(), max=pos.max(0).tolist()),
           _acc(1, 5125, 12, "SCALAR"), _acc(2, 5123, 6, "VEC4"), _acc(3, 5126, 6, "VEC4"),
           _acc(4, 5126, 2, "MAT4"), _acc(5, 5126, 2, "SCALAR"), _acc(6, 5126, 2, "VEC4")]
    doc = _doc(arrays, acc, [{"attributes": {"POSITION": 0, "JOINTS_0": 2, "WEIGHTS_0": 3},
                              "indices": 1}],
               skins=[{"joints": [1, 2], "inverseBindMatrices": 4}],
               nodes=[{"mesh": 0, "skin": 0}, {"children": [2]}, {"translation": [0.0, 1.0, 0.0]}],
               animations=[{"channels": [{"sampler": 0, "target": {"node": 2, "path": "rotation"}}],
                            "samplers": [{"input": 5, "output": 6, "interpolation": "LINEAR"}]}],
               scenes=[{"nodes": [0, 1]}])
    return _write(path + ".gltf", doc)


def case_textured(path, *_):
    """A GLB-style bufferView RGBA PNG of another size than the atlas's
    (resized down) with partial alpha, and a data-URI palette PNG with
    tRNS (resized up)."""
    rng = np.random.default_rng(11)
    rgba = rng.integers(0, 256, (20, 24, 4), dtype=np.uint8)
    rgba[..., 3][rng.random((20, 24)) < 0.5] = 255
    pal = Image.fromarray(rng.integers(0, 256, (6, 5, 3), dtype=np.uint8)).quantize(9)
    buf = io.BytesIO()
    pal.save(buf, format="PNG", transparency=bytes([0, 128, 255, 7]))
    png0 = np.frombuffer(_png(rgba), np.uint8)
    pos, idx, box = _box()
    uv = box.uvs.astype(np.float32)
    arrays = (pos, uv, idx, png0)
    doc = _doc(arrays, [_acc(0, 5126, len(pos), "VEC3", min=pos.min(0).tolist(),
                             max=pos.max(0).tolist()),
                        _acc(1, 5126, len(uv), "VEC2"), _acc(2, 5125, len(idx), "SCALAR")],
               [{"attributes": {"POSITION": 0, "TEXCOORD_0": 1}, "indices": 2, "material": 0}],
               images=[{"bufferView": 3, "mimeType": "image/png"},
                       {"uri": "data:image/png;base64," + base64.b64encode(buf.getvalue()).decode()}],
               textures=[{"source": 0}, {"source": 1}],
               materials=[{"pbrMetallicRoughness": {"baseColorTexture": {"index": 0},
                                                    "roughnessFactor": 1.0},
                           "normalTexture": {"index": 1}}])
    return _write(path + ".gltf", doc)


def case_cubicspline_two_animations(path, *_):
    times = np.array([0.0, 1.0], np.float32)
    cs = np.array([[[0, 0, 0], [0, 0, 0], [3, 0, 0]], [[-1, 0, 0], [1, 0, 0], [0, 0, 0]]],
                  np.float32)
    lin = np.array([[0, 0, 0], [0, 2, 0]], np.float32)
    doc = _skin_doc((times, cs.reshape(6, 3), lin),
                    [{"input": 4, "output": 5, "interpolation": "CUBICSPLINE"},
                     {"input": 4, "output": 6, "interpolation": "LINEAR"}])
    return _write(path + ".gltf", doc)


def case_step(path, *_):
    times = np.array([0.0, 0.7, 1.0], np.float32)
    vals = np.array([[0, 0, 0], [3, 0, 0], [9, 0, 0]], np.float32)
    doc = _skin_doc((times, vals), [{"input": 4, "output": 5, "interpolation": "STEP"}])
    return _write(path + ".gltf", doc)


def case_interleaved_byte_stride(path, *_):
    pos, idx, box = _box()
    inter = np.concatenate([pos, box.normals.astype(np.float32)], axis=1)
    doc = _doc((inter, idx), [_acc(0, 5126, len(pos), "VEC3", byteOffset=0,
                                   min=pos.min(0).tolist(), max=pos.max(0).tolist()),
                              _acc(0, 5126, len(pos), "VEC3", byteOffset=12),
                              _acc(1, 5125, len(idx), "SCALAR")],
               [{"attributes": {"POSITION": 0, "NORMAL": 1}, "indices": 2}],
               views=[{"buffer": 0, "byteOffset": 0, "byteLength": inter.nbytes, "byteStride": 24},
                      {"buffer": 0, "byteOffset": inter.nbytes, "byteLength": idx.nbytes}])
    return _write(path + ".gltf", doc)


def _small_index_case(comp_type, dtype):
    def case(path, *_):
        pos, _, box = _box()
        idx = box.indices.astype(dtype).reshape(-1, 1)
        doc = _doc((pos, idx), [_acc(0, 5126, len(pos), "VEC3", min=pos.min(0).tolist(),
                                     max=pos.max(0).tolist()), _acc(1, comp_type, idx.size, "SCALAR")],
                   [{"attributes": {"POSITION": 0}, "indices": 1}])
        return _write(path + ".gltf", doc)
    return case


def case_sparse_accessor(path, *_):
    pos, idx, _ = _box()
    sp_idx = np.asarray([2, 5], np.uint16)
    sp_val = np.asarray([[9.0, 9.0, 9.0], [-9.0, 0.0, 1.0]], np.float32)
    doc = _doc((pos, idx, sp_idx, sp_val),
               [_acc(0, 5126, len(pos), "VEC3", min=pos.min(0).tolist(), max=pos.max(0).tolist(),
                     sparse={"count": 2, "indices": {"bufferView": 2, "componentType": 5123},
                             "values": {"bufferView": 3}}),
                _acc(1, 5125, len(idx), "SCALAR")],
               [{"attributes": {"POSITION": 0}, "indices": 1}])
    return _write(path + ".gltf", doc)


def case_normalized_u16_uvs(path, *_):
    pos, idx, box = _box()
    uv = np.round(np.clip(box.uvs.astype(np.float32), 0, 1) * 65535.0).astype(np.uint16)
    doc = _doc((pos, uv, idx), [_acc(0, 5126, len(pos), "VEC3", min=pos.min(0).tolist(),
                                     max=pos.max(0).tolist()),
                                _acc(1, 5123, len(pos), "VEC2", normalized=True),
                                _acc(2, 5125, len(idx), "SCALAR")],
               [{"attributes": {"POSITION": 0, "TEXCOORD_0": 1}, "indices": 2}])
    return _write(path + ".gltf", doc)


def case_interleaved_overrun(path, *_):
    pos, _, _ = _box()
    doc = _doc((pos,), [_acc(0, 5126, len(pos), "VEC3", min=pos.min(0).tolist(),
                             max=pos.max(0).tolist())],
               [{"attributes": {"POSITION": 0}}],
               views=[{"buffer": 0, "byteOffset": 0, "byteLength": pos.nbytes, "byteStride": 64}])
    return _write(path + ".gltf", doc)


def _write(path, doc):
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


CASES = {
    "roundtrip_geometry": case_roundtrip_geometry,
    "roundtrip_instances_and_materials": case_roundtrip_instances_and_materials,
    "loaded_scene": case_loaded_scene,
    "node_hierarchy_and_matrix": case_node_hierarchy_and_matrix,
    "skinned": case_skinned,
    "textured": case_textured,
    "cubicspline_two_animations": case_cubicspline_two_animations,
    "step": case_step,
    "interleaved_byte_stride": case_interleaved_byte_stride,
    "u8_indices": _small_index_case(5121, np.uint8),
    "u16_indices": _small_index_case(5123, np.uint16),
    "sparse_accessor": case_sparse_accessor,
    "normalized_u16_uvs": case_normalized_u16_uvs,
}


def load_both(path, atlas_size=16):
    port = load_gltf(path, SceneBuilder(SceneLimits.tiny(), atlas_size=atlas_size))
    jax = jax_load(path, JaxBuilder(JaxLimits.tiny(), atlas_size=atlas_size))
    for b in (port, jax):
        b.add_light(position=(2, 3, 4), intensity=20.0)
    return port, jax


@pytest.mark.parametrize("name", sorted(CASES))
def test_loaders_build_the_same_tables(tmp_path, name):
    path = CASES[name](str(tmp_path / name), write_glb, primitives)
    port, jax = load_both(path)
    assert len(port._meshes) == len(jax._meshes) >= 1
    assert port._instances and len(port._instances) == len(jax._instances)
    assert_scene_tables_equal(port.build(device="cpu"), jax.build())
    if name == "textured":
        assert [m["base_color_tex"] for m in port._materials] == [0]
        assert [m["normal_tex"] for m in port._materials] == [1]
        for got, want in zip(port.atlas.layers, jax.atlas.layers):
            assert np.array_equal(got, want)
    if name in ("skinned", "cubicspline_two_animations", "step"):
        assert port._skins and len(port._skins[0]["clips"]) == len(jax._skins[0]["clips"])


def test_interleaved_overrun_raises_in_both(tmp_path):
    path = case_interleaved_overrun(str(tmp_path / "overrun"))
    for load, builder in ((load_gltf, SceneBuilder), (jax_load, JaxBuilder)):
        with pytest.raises(ValueError, match="overruns"):
            load(path, builder(SceneLimits.tiny()))


@pytest.mark.parametrize("name", ["roundtrip_geometry", "roundtrip_instances_and_materials",
                                  "loaded_scene"])
def test_write_glb_gives_the_same_bytes(tmp_path, name):
    got = CASES[name](str(tmp_path / "port"), write_glb, primitives)
    want = CASES[name](str(tmp_path / "jax"), jax_write, jprim)
    with open(got, "rb") as f, open(want, "rb") as g:
        assert f.read() == g.read()


def test_undecodable_image_warns_and_gives_minus_one(tmp_path):
    path = case_textured(str(tmp_path / "bad"))
    with open(path) as f:
        doc = json.load(f)
    doc["images"][1]["uri"] = "data:image/png;base64," + base64.b64encode(b"\x89PNG\r\n\x1a\nxx").decode()
    _write(path, doc)
    with pytest.warns(UserWarning, match="image 1"):
        port, jax = load_both(path)
    assert port._materials[0]["normal_tex"] == jax._materials[0]["normal_tex"] == -1
    assert port._materials[0]["base_color_tex"] == 0


def test_loaded_scene_renders_as_the_jax_package(tmp_path):
    path = case_loaded_scene(str(tmp_path / "scene"), write_glb, primitives)
    port, jax = load_both(path)
    outputs = ("image", "vis", "soup")
    got = Renderer(port.build(device="cpu"), PipelineConfig(width=128, height=128, tri_capacity=256),
                   outputs=outputs).render(Camera.create([0.0, 0.5, 3.0], device="cpu"))
    want = JaxRenderer(jax.build(), JaxConfig(width=128, height=128, tri_capacity=256),
                       outputs=outputs).render(JaxCamera.create(position=jnp.array([0.0, 0.5, 3.0])))
    got_id, want_id = got["vis"].tri_id.numpy(), np.asarray(want["vis"].tri_id)
    assert (got_id >= 0).mean() > 0.1
    same = visible_identity(got, got_id) == visible_identity(want, want_id)
    assert same.mean() >= 0.999, f"visible triangle differs on {(~same).sum()} pixels"
    assert psnr(np.clip(got["image"].numpy(), 0, 1), np.clip(np.asarray(want["image"]), 0, 1)) >= 50
