"""glTF 2.0 / GLB loader and writer (``renderer_tpu.scene.gltf``), numpy
only.

Reads POSITION/NORMAL/TEXCOORD_0/TANGENT attributes, indices, skins with
their animations, and pbrMetallicRoughness materials from .gltf/.glb files
into the port's ``SceneBuilder``, filling the same host tables as the JAX
loader; writes .glb so procedural scenes round-trip through the container.

Images decode with ``utils.image.decode_png`` and resize with
``resize_bilinear_u8`` (Pillow's BILINEAR, bit for bit), so PNG textures
need no Pillow. Another format goes through Pillow when it is importable.
An image that does not decode gives the texture layer -1, as in the JAX
loader, with a warning naming the image and the reason.

Conventions: glTF is right-handed y-up with CCW front faces, as the
renderer is, so no axis surgery. glTF quaternions are (x, y, z, w); ours
are (w, x, y, z).
"""

from __future__ import annotations

import base64
import io
import json
import os
import struct
import warnings
import zlib
from typing import Optional

import numpy as np

from renderer_tpu_torch.scene.builder import HostMesh, SceneBuilder
from renderer_tpu_torch.utils.image import as_rgba, decode_png

_GLB_MAGIC = 0x46546C67  # 'glTF'
_CHUNK_JSON = 0x4E4F534A
_CHUNK_BIN = 0x004E4942

_COMPONENT_DTYPES = {
    5120: np.int8,
    5121: np.uint8,
    5122: np.int16,
    5123: np.uint16,
    5125: np.uint32,
    5126: np.float32,
}
_TYPE_COUNTS = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------

def _read_container(path: str):
    """Returns (gltf json dict, list of binary buffers)."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) >= 12 and struct.unpack_from("<I", data, 0)[0] == _GLB_MAGIC:
        _, version, _ = struct.unpack_from("<III", data, 0)
        if version != 2:
            raise ValueError(f"unsupported GLB version {version}")
        off = 12
        doc = None
        bin_chunk = None
        while off < len(data):
            clen, ctype = struct.unpack_from("<II", data, off)
            off += 8
            chunk = data[off : off + clen]
            off += clen
            if ctype == _CHUNK_JSON:
                doc = json.loads(chunk.decode("utf-8"))
            elif ctype == _CHUNK_BIN:
                bin_chunk = chunk
        if doc is None:
            raise ValueError("GLB missing JSON chunk")
    else:
        doc = json.loads(data.decode("utf-8"))
        bin_chunk = None

    buffers = []
    base = os.path.dirname(path)
    for buf in doc.get("buffers", []):
        uri = buf.get("uri")
        if uri is None:
            if bin_chunk is None:
                raise ValueError("buffer without uri and no GLB BIN chunk")
            buffers.append(bin_chunk)
        elif uri.startswith("data:"):
            b64 = uri.split(",", 1)[1]
            buffers.append(base64.b64decode(b64))
        else:
            with open(os.path.join(base, uri), "rb") as f:
                buffers.append(f.read())
    return doc, buffers


def _read_accessor(doc, buffers, idx) -> np.ndarray:
    acc = doc["accessors"][idx]
    n = acc["count"]
    ncomp = _TYPE_COUNTS[acc["type"]]
    dtype = _COMPONENT_DTYPES[acc["componentType"]]
    itemsize = np.dtype(dtype).itemsize * ncomp

    if "bufferView" not in acc:
        # spec: accessor without bufferView reads as zeros (the sparse
        # substitution below then fills in the stored elements)
        out = np.zeros((n, ncomp), dtype)
    else:
        bv = doc["bufferViews"][acc["bufferView"]]
        buf = buffers[bv["buffer"]]
        start = bv.get("byteOffset", 0) + acc.get("byteOffset", 0)
        stride = bv.get("byteStride") or itemsize
        if stride == itemsize:
            out = np.frombuffer(
                buf, dtype=dtype, count=n * ncomp, offset=start
            ).reshape(n, ncomp)
        else:
            # interleaved bufferView (foreign exporters pack several
            # attributes per vertex row): vectorized strided view, not a
            # per-row Python loop (100k-vertex meshes matter)
            raw = np.frombuffer(buf, np.uint8)
            end = start + (n - 1) * stride + itemsize
            if end > len(raw):
                raise ValueError(
                    f"accessor {idx}: interleaved view overruns buffer "
                    f"({end} > {len(raw)})"
                )
            win = np.lib.stride_tricks.sliding_window_view(raw, itemsize)
            rows = win[start : start + (n - 1) * stride + 1 : stride]
            out = np.ascontiguousarray(rows).view(dtype).reshape(n, ncomp)
    if "sparse" in acc:
        # sparse accessor: base (often zeros) + stored (index, value) pairs
        sp = acc["sparse"]
        cnt = sp["count"]
        sidx = _read_view_scalar(
            doc, buffers, sp["indices"], cnt,
            _COMPONENT_DTYPES[sp["indices"]["componentType"]],
        )
        sval_dt = dtype
        sval = _read_view_scalar(
            doc, buffers, sp["values"], cnt * ncomp, sval_dt
        ).reshape(cnt, ncomp)
        out = out.copy()
        out[sidx.astype(np.int64)] = sval
    if acc.get("normalized") and dtype != np.float32:
        out = out.astype(np.float32) / np.iinfo(dtype).max
    return out.copy()


def _read_view_scalar(doc, buffers, ref, count, dtype) -> np.ndarray:
    """Tightly-packed read of `count` scalars from a sparse-block view ref
    ({bufferView, byteOffset?})."""
    bv = doc["bufferViews"][ref["bufferView"]]
    buf = buffers[bv["buffer"]]
    start = bv.get("byteOffset", 0) + ref.get("byteOffset", 0)
    return np.frombuffer(buf, dtype=dtype, count=count, offset=start)


def _node_matrix(node) -> np.ndarray:
    if "matrix" in node:
        return np.asarray(node["matrix"], np.float64).reshape(4, 4).T  # column major
    m = np.eye(4)
    if "scale" in node:
        m = m @ np.diag(list(node["scale"]) + [1.0])
    if "rotation" in node:
        x, y, z, w = node["rotation"]
        r = np.array(
            [
                [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
            ]
        )
        rm = np.eye(4)
        rm[:3, :3] = r
        m = rm @ m
    if "translation" in node:
        tm = np.eye(4)
        tm[:3, 3] = node["translation"]
        m = tm @ m
    return m


def _decompose_trs(m: np.ndarray):
    """4x4 -> (translation, quat (w,x,y,z), uniform scale). Assumes no shear;
    anisotropic scale is averaged (SceneBuilder instances are uniform-scale,
    like the reference's Scale component)."""
    t = m[:3, 3].copy()
    lin = m[:3, :3]
    scales = np.linalg.norm(lin, axis=0)
    s = float(np.mean(scales))
    r = lin / np.where(scales == 0, 1.0, scales)[None, :]
    # handle reflection
    if np.linalg.det(r) < 0:
        r = -r
        s = -s
    tr = np.trace(r)
    if tr > 0:
        q0 = np.sqrt(1 + tr) / 2
        w = q0
        x = (r[2, 1] - r[1, 2]) / (4 * q0)
        y = (r[0, 2] - r[2, 0]) / (4 * q0)
        z = (r[1, 0] - r[0, 1]) / (4 * q0)
    else:
        i = int(np.argmax(np.diag(r)))
        j, k = (i + 1) % 3, (i + 2) % 3
        qi = np.sqrt(max(r[i, i] - r[j, j] - r[k, k] + 1, 0)) / 2
        qj = (r[j, i] + r[i, j]) / (4 * qi)
        qk = (r[k, i] + r[i, k]) / (4 * qi)
        w = (r[k, j] - r[j, k]) / (4 * qi)
        q = np.zeros(3)
        q[i], q[j], q[k] = qi, qj, qk
        x, y, z = q
    quat = np.array([w, x, y, z], np.float32)
    quat /= np.linalg.norm(quat)
    return t.astype(np.float32), quat, s


def _node_trs(node):
    """Static local TRS of a node -> (t (3,), r (w,x,y,z), s scalar)."""
    if "matrix" in node:
        return _decompose_trs(_node_matrix(node))
    t = np.asarray(node.get("translation", [0, 0, 0]), np.float32)
    rx = node.get("rotation", [0, 0, 0, 1])  # glTF xyzw
    r = np.array([rx[3], rx[0], rx[1], rx[2]], np.float32)
    s = float(np.mean(node.get("scale", [1, 1, 1])))
    return t, r, s


def _parse_skins_and_animations(doc, buffers, n_keys: int = 32) -> dict:
    """glTF skins + animations -> per-skin args for SceneBuilder.add_skinned_mesh.

    Joints are reordered topologically (parent before child). Single-mode
    animations are resampled at the UNION of their channels' key times with
    the sampler's interpolation preserved — exact reproduction for LINEAR
    and STEP, and for CUBICSPLINE too (values + one-sided hermite derivative
    tangents at every knot reproduce the original piecewise cubic).
    Mixed-mode or knot-heavy animations fall back to n_keys dense uniform
    LINEAR keys (exact at each key). Assumes skeleton roots sit under an
    identity world transform. Returns {skin_index: {remap, parents,
    inverse_bind, clips: [...]}}.
    """
    nodes = doc.get("nodes", [])
    parent_of = {}
    for ni, node in enumerate(nodes):
        for c in node.get("children", []):
            parent_of[c] = ni

    out = {}
    for si, skin in enumerate(doc.get("skins", [])):
        joints = list(skin["joints"])
        jset = set(joints)
        # topological order: parents (within the joint set) first
        order = []
        seen = set()

        def add(nj):
            if nj in seen:
                return
            p = parent_of.get(nj)
            if p is not None and p in jset:
                add(p)
            seen.add(nj)
            order.append(nj)

        for nj in joints:
            add(nj)
        node_to_topo = {nj: k for k, nj in enumerate(order)}
        remap = np.array([node_to_topo[nj] for nj in joints], np.int32)
        parents = np.array(
            [
                node_to_topo.get(parent_of.get(nj, -1), -1)
                if parent_of.get(nj) in jset
                else -1
                for nj in order
            ],
            np.int32,
        )
        j = len(order)
        if "inverseBindMatrices" in skin:
            ibm_raw = _read_accessor(doc, buffers, skin["inverseBindMatrices"])
            ibm_gltf = ibm_raw.reshape(-1, 4, 4).transpose(0, 2, 1)  # col-major
        else:
            ibm_gltf = np.tile(np.eye(4, dtype=np.float32), (len(joints), 1, 1))
        inverse_bind = np.tile(np.eye(4, dtype=np.float32), (j, 1, 1))
        for local, nj in enumerate(joints):
            inverse_bind[node_to_topo[nj]] = ibm_gltf[local]

        # EVERY animation touching this skin becomes a clip (multi-clip;
        # runtime selection via skins.active_clip)
        anim_chans = []  # list of (node -> {path: (times, values, mode)})
        for anim in doc.get("animations", []):
            chans = {}
            for ch in anim.get("channels", []):
                tgt = ch.get("target", {})
                nj = tgt.get("node")
                if nj not in jset:
                    continue
                samp = anim["samplers"][ch["sampler"]]
                times = _read_accessor(doc, buffers, samp["input"]).reshape(-1)
                vals = _read_accessor(doc, buffers, samp["output"])
                mode = samp.get("interpolation", "LINEAR")
                chans.setdefault(nj, {})[tgt["path"]] = (
                    times.astype(np.float32), vals.astype(np.float32), mode
                )
            if chans:
                anim_chans.append(chans)
        if not anim_chans:
            anim_chans = [{}]

        def resample(times, vals, mode, t, side="right"):
            """Sample a glTF sampler at time t, exactly per its mode
            (CUBICSPLINE output stride is [in-tangent, value, out-tangent]).
            side selects the segment at knot times (one-sided limits)."""
            if mode == "CUBICSPLINE":
                vals = vals.reshape(len(times), 3, -1)
            if len(times) == 1:
                return vals[0, 1] if mode == "CUBICSPLINE" else vals[0]
            i = np.clip(np.searchsorted(times, t, side=side), 1, len(times) - 1)
            t0, t1 = times[i - 1], times[i]
            dt = t1 - t0
            f = 0.0 if dt <= 0 else float(np.clip((t - t0) / dt, 0.0, 1.0))
            if mode == "STEP":
                return vals[i - 1]
            if mode == "CUBICSPLINE":
                v0, b0 = vals[i - 1, 1], vals[i - 1, 2]
                v1, a1 = vals[i, 1], vals[i, 0]
                f2, f3 = f * f, f * f * f
                return (
                    (2 * f3 - 3 * f2 + 1) * v0
                    + dt * (f3 - 2 * f2 + f) * b0
                    + (-2 * f3 + 3 * f2) * v1
                    + dt * (f3 - f2) * a1
                )
            return vals[i - 1] * (1 - f) + vals[i] * f

        def deriv(times, vals, mode, t, side):
            """d/dt of a CUBICSPLINE sampler at t, one-sided at knots —
            feeding these back as tangents reproduces the original
            piecewise cubic EXACTLY after union-time resampling."""
            if mode != "CUBICSPLINE":
                return np.zeros_like(resample(times, vals, mode, t))
            vals3 = vals.reshape(len(times), 3, -1)
            if len(times) == 1:
                return np.zeros_like(vals3[0, 1])
            i = np.clip(np.searchsorted(times, t, side=side), 1, len(times) - 1)
            t0, t1 = times[i - 1], times[i]
            dt = t1 - t0
            if dt <= 0:
                return np.zeros_like(vals3[0, 1])
            f = float(np.clip((t - t0) / dt, 0.0, 1.0))
            v0, b0 = vals3[i - 1, 1], vals3[i - 1, 2]
            v1, a1 = vals3[i, 1], vals3[i, 0]
            f2 = f * f
            return (
                (6 * f2 - 6 * f) * v0 / dt
                + (3 * f2 - 4 * f + 1) * b0
                + (-6 * f2 + 6 * f) * v1 / dt
                + (3 * f2 - 2 * f) * a1
            )

        clips = []
        for chans in anim_chans:
            duration = 1.0
            mode_set = set()
            union = {0.0}
            for d in chans.values():
                for times, _, mode in d.values():
                    duration = max(duration, float(times[-1]))
                    mode_set.add(mode)
                    union.update(float(t) for t in times)
            union.add(duration)
            union_times = np.asarray(sorted(u for u in union if u <= duration), np.float32)
            if len(mode_set) <= 1 and len(union_times) <= n_keys:
                # single-mode animation: resample at the UNION of channel key
                # times and keep the mode — STEP/LINEAR reproduce exactly,
                # CUBICSPLINE exactly too via one-sided derivative tangents
                key_times = union_times
                mode = mode_set.pop() if mode_set else "LINEAR"
            else:
                # mixed modes or too many knots: dense uniform keys, exact at
                # each key time, LINEAR playback between them (approximate)
                key_times = np.linspace(0.0, duration, n_keys, dtype=np.float32)
                mode = "LINEAR"
            nk = len(key_times)
            key_t = np.zeros((nk, j, 3), np.float32)
            key_r = np.zeros((nk, j, 4), np.float32)
            key_s = np.ones((nk, j), np.float32)
            cubic = mode == "CUBICSPLINE"
            t_in = np.zeros((nk, j, 3), np.float32)
            t_out = np.zeros((nk, j, 3), np.float32)
            r_in = np.zeros((nk, j, 4), np.float32)
            r_out = np.zeros((nk, j, 4), np.float32)
            s_in = np.zeros((nk, j), np.float32)
            s_out = np.zeros((nk, j), np.float32)

            def quat_wxyz(q):
                return [q[3], q[0], q[1], q[2]]

            for nj in order:
                k = node_to_topo[nj]
                base_t, base_r, base_s = _node_trs(nodes[nj])
                d = chans.get(nj, {})
                for ki, t in enumerate(key_times):
                    if "translation" in d:
                        key_t[ki, k] = resample(*d["translation"], t)
                        if cubic:
                            t_in[ki, k] = deriv(*d["translation"], t, "left")
                            t_out[ki, k] = deriv(*d["translation"], t, "right")
                    else:
                        key_t[ki, k] = base_t
                    if "rotation" in d:
                        q = resample(*d["rotation"], t)  # xyzw
                        if cubic:
                            # raw components (spec: cubic operates unnormalized)
                            key_r[ki, k] = quat_wxyz(q)
                            r_in[ki, k] = quat_wxyz(deriv(*d["rotation"], t, "left"))
                            r_out[ki, k] = quat_wxyz(deriv(*d["rotation"], t, "right"))
                        else:
                            q = q / max(np.linalg.norm(q), 1e-8)
                            key_r[ki, k] = quat_wxyz(q)
                    else:
                        key_r[ki, k] = base_r
                    if "scale" in d:
                        key_s[ki, k] = float(np.mean(resample(*d["scale"], t)))
                        if cubic:
                            s_in[ki, k] = float(np.mean(deriv(*d["scale"], t, "left")))
                            s_out[ki, k] = float(np.mean(deriv(*d["scale"], t, "right")))
                    else:
                        key_s[ki, k] = base_s
            clips.append(
                dict(
                    key_times=key_times, key_t=key_t, key_r=key_r, key_s=key_s,
                    interpolation=mode,
                    key_t_tangents=(t_in, t_out) if cubic else None,
                    key_r_tangents=(r_in, r_out) if cubic else None,
                    key_s_tangents=(s_in, s_out) if cubic else None,
                )
            )

        out[si] = dict(
            remap=remap,
            parents=parents,
            inverse_bind=inverse_bind,
            clips=clips,
        )
    return out


def _image_bytes(doc, buffers, img, path: str) -> bytes:
    """An image's encoded bytes: from a bufferView, a data URI or a file
    next to the glTF."""
    if "bufferView" in img:
        bv = doc["bufferViews"][img["bufferView"]]
        start = bv.get("byteOffset", 0)
        return bytes(buffers[bv["buffer"]][start:start + bv["byteLength"]])
    uri = img["uri"]
    if uri.startswith("data:"):
        return base64.b64decode(uri.split(",", 1)[1])
    with open(os.path.join(os.path.dirname(path), uri), "rb") as f:
        return f.read()


def _decode_image(doc, buffers, img, path: str) -> np.ndarray:
    """(H, W, 4) uint8 RGBA of a glTF image, as Pillow's
    ``convert("RGBA")`` gives it. PNGs decode here; another format needs
    Pillow (ImportError without it)."""
    raw = _image_bytes(doc, buffers, img, path)
    if raw[:8] == b"\x89PNG\r\n\x1a\n":
        return as_rgba(decode_png(raw))
    from PIL import Image

    with Image.open(io.BytesIO(raw)) as pil:
        return np.asarray(pil.convert("RGBA"))


def load_gltf(
    path: str,
    builder: Optional[SceneBuilder] = None,
    load_textures: bool = True,
    default_material: bool = True,
) -> SceneBuilder:
    """Load a .gltf/.glb file into a SceneBuilder (meshes, materials,
    instances from the default scene's node hierarchy)."""
    doc, buffers = _read_container(path)
    b = builder or SceneBuilder()

    # textures -> atlas layers
    tex_layer: dict[int, int] = {}
    atlas = getattr(b, "atlas", None)
    if load_textures and doc.get("images") and atlas is not None:
        for ti, tex in enumerate(doc.get("textures", [])):
            img_idx = tex.get("source")
            if img_idx is None:
                continue
            try:
                arr = _decode_image(doc, buffers, doc["images"][img_idx], path)
            except (ValueError, OSError, ImportError, KeyError, zlib.error) as e:
                warnings.warn(f"{path}: image {img_idx} (texture {ti}) not decoded, "
                              f"layer -1: {type(e).__name__}: {e}", stacklevel=2)
                tex_layer[ti] = -1
                continue
            tex_layer[ti] = atlas.add(arr)

    # materials
    mat_ids = []
    for mat in doc.get("materials", []):
        pbr = mat.get("pbrMetallicRoughness", {})
        bc = pbr.get("baseColorFactor", [1, 1, 1, 1])
        bct = pbr.get("baseColorTexture", {}).get("index", -1)
        nt = mat.get("normalTexture", {}).get("index", -1)
        mat_ids.append(
            b.add_material(
                base_color=bc,
                metallic=pbr.get("metallicFactor", 1.0),
                roughness=pbr.get("roughnessFactor", 1.0),
                emissive=mat.get("emissiveFactor", [0, 0, 0]),
                base_color_tex=tex_layer.get(bct, -1),
                normal_tex=tex_layer.get(nt, -1),
            )
        )
    if not mat_ids and default_material:
        mat_ids = [b.add_material()]

    # which skin (if any) each glTF mesh is used with (first-wins; per the
    # spec, skinned meshes take their transform from the joints)
    mesh_skin: dict[int, int] = {}
    for node in doc.get("nodes", []):
        if "mesh" in node and "skin" in node:
            mesh_skin.setdefault(node["mesh"], node["skin"])

    skin_args = _parse_skins_and_animations(
        doc, buffers, n_keys=min(32, b.limits.max_keyframes)
    )

    # meshes: one HostMesh per primitive; mesh index -> list of (mesh_id, mat)
    prim_table: list[list] = []
    for mesh_idx, mesh in enumerate(doc.get("meshes", [])):
        prims = []
        for prim in mesh["primitives"]:
            attrs = prim["attributes"]
            pos = _read_accessor(doc, buffers, attrs["POSITION"]).astype(np.float32)
            nrm = (
                _read_accessor(doc, buffers, attrs["NORMAL"]).astype(np.float32)
                if "NORMAL" in attrs
                else None
            )
            uv = (
                _read_accessor(doc, buffers, attrs["TEXCOORD_0"]).astype(np.float32)
                if "TEXCOORD_0" in attrs
                else None
            )
            tan = (
                _read_accessor(doc, buffers, attrs["TANGENT"]).astype(np.float32)
                if "TANGENT" in attrs
                else None
            )
            if "indices" in prim:
                idx = _read_accessor(doc, buffers, prim["indices"]).reshape(-1).astype(np.int32)
            else:
                idx = np.arange(len(pos), dtype=np.int32)
            hm = HostMesh(
                positions=pos, indices=idx.reshape(-1, 3), normals=nrm, uvs=uv, tangents=tan
            )
            mat = prim.get("material")
            mid = mat_ids[mat] if mat is not None and mat < len(mat_ids) else (
                mat_ids[0] if mat_ids else 0
            )
            skin_idx = mesh_skin.get(mesh_idx)
            if (
                skin_idx is not None
                and skin_idx in skin_args
                and "JOINTS_0" in attrs
                and "WEIGHTS_0" in attrs
            ):
                joints_raw = _read_accessor(doc, buffers, attrs["JOINTS_0"]).astype(np.int32)
                weights = _read_accessor(doc, buffers, attrs["WEIGHTS_0"]).astype(np.float32)
                wsum = weights.sum(axis=-1, keepdims=True)
                weights = weights / np.where(wsum > 0, wsum, 1.0)
                sa = skin_args[skin_idx]
                clips = sa["clips"]
                mesh_id = b.add_skinned_mesh(
                    hm,
                    sa["remap"][joints_raw],  # glTF joint order -> topo order
                    weights,
                    sa["parents"],
                    sa["inverse_bind"],
                    clips[0]["key_times"],
                    clips[0]["key_t"],
                    clips[0]["key_r"],
                    clips[0]["key_s"],
                    interpolation=clips[0]["interpolation"],
                    key_t_tangents=clips[0]["key_t_tangents"],
                    key_r_tangents=clips[0]["key_r_tangents"],
                    key_s_tangents=clips[0]["key_s_tangents"],
                )
                for clip in clips[1 : b.limits.max_clips]:
                    b.add_skin_clip(
                        mesh_id, clip["key_times"], clip["key_t"],
                        clip["key_r"], clip["key_s"],
                        interpolation=clip["interpolation"],
                        key_t_tangents=clip["key_t_tangents"],
                        key_r_tangents=clip["key_r_tangents"],
                        key_s_tangents=clip["key_s_tangents"],
                    )
            else:
                mesh_id = b.add_mesh(hm)
            prims.append((mesh_id, mid))
        prim_table.append(prims)

    # scene graph -> flattened instances
    scene_idx = doc.get("scene", 0)
    scenes = doc.get("scenes", [])
    roots = scenes[scene_idx]["nodes"] if scenes else range(len(doc.get("nodes", [])))
    nodes = doc.get("nodes", [])

    def visit(node_idx, parent):
        node = nodes[node_idx]
        world = parent @ _node_matrix(node)
        if "mesh" in node:
            if "skin" in node:
                # skinned meshes take their transform from the joints (spec)
                t, q, s = np.zeros(3, np.float32), np.array([1, 0, 0, 0], np.float32), 1.0
            else:
                t, q, s = _decompose_trs(world)
            for mesh_id, mat in prim_table[node["mesh"]]:
                b.add_instance(mesh_id, mat, translation=t, rotation=q, scale=s)
        for child in node.get("children", []):
            visit(child, world)

    for r in roots:
        visit(r, np.eye(4))
    return b


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------

def write_glb(
    path: str,
    meshes: list,
    instances: Optional[list] = None,
    materials: Optional[list] = None,
) -> None:
    """Write a .glb: meshes = [HostMesh], instances = [(mesh_idx, mat_idx,
    translation, rotation (w,x,y,z), scale)], materials = [dict(base_color,
    metallic, roughness)]. Minimal but spec-conformant."""
    blob = bytearray()
    buffer_views = []
    accessors = []

    def add_data(arr: np.ndarray, target=None):
        arr = np.ascontiguousarray(arr)
        while len(blob) % 4:
            blob.append(0)
        off = len(blob)
        blob.extend(arr.tobytes())
        bv = {"buffer": 0, "byteOffset": off, "byteLength": arr.nbytes}
        if target:
            bv["target"] = target
        buffer_views.append(bv)
        return len(buffer_views) - 1

    def add_accessor(arr, comp_type, type_str, target=None, minmax=False):
        bv = add_data(arr, target)
        acc = {
            "bufferView": bv,
            "componentType": comp_type,
            "count": len(arr),
            "type": type_str,
        }
        if minmax:
            acc["min"] = np.asarray(arr).min(axis=0).tolist()
            acc["max"] = np.asarray(arr).max(axis=0).tolist()
        accessors.append(acc)
        return len(accessors) - 1

    gltf_meshes = []
    for m in meshes:
        attrs = {
            "POSITION": add_accessor(m.positions.astype(np.float32), 5126, "VEC3", 34962, True),
            "NORMAL": add_accessor(m.normals.astype(np.float32), 5126, "VEC3", 34962),
            "TEXCOORD_0": add_accessor(m.uvs.astype(np.float32), 5126, "VEC2", 34962),
            "TANGENT": add_accessor(m.tangents.astype(np.float32), 5126, "VEC4", 34962),
        }
        idx = add_accessor(
            m.indices.reshape(-1, 1).astype(np.uint32), 5125, "SCALAR", 34963
        )
        prim = {"attributes": attrs, "indices": idx, "mode": 4}
        gltf_meshes.append({"primitives": [prim]})

    gltf_materials = []
    for mat in materials or []:
        gltf_materials.append(
            {
                "pbrMetallicRoughness": {
                    "baseColorFactor": list(map(float, mat.get("base_color", (1, 1, 1, 1)))),
                    "metallicFactor": float(mat.get("metallic", 0.0)),
                    "roughnessFactor": float(mat.get("roughness", 0.8)),
                }
            }
        )

    gltf_nodes = []
    for inst in instances or [(i, 0, (0, 0, 0), (1, 0, 0, 0), 1.0) for i in range(len(meshes))]:
        mesh_idx, mat_idx, t, q, s = inst
        if gltf_materials:
            gltf_meshes[mesh_idx]["primitives"][0]["material"] = mat_idx
        w, x, y, z = q
        gltf_nodes.append(
            {
                "mesh": mesh_idx,
                "translation": list(map(float, t)),
                "rotation": [float(x), float(y), float(z), float(w)],  # xyzw
                "scale": [float(s)] * 3,
            }
        )

    doc = {
        "asset": {"version": "2.0", "generator": "renderer_tpu"},
        "buffers": [{"byteLength": len(blob)}],
        "bufferViews": buffer_views,
        "accessors": accessors,
        "meshes": gltf_meshes,
        "nodes": gltf_nodes,
        "scenes": [{"nodes": list(range(len(gltf_nodes)))}],
        "scene": 0,
    }
    if gltf_materials:
        doc["materials"] = gltf_materials

    js = json.dumps(doc).encode("utf-8")
    while len(js) % 4:
        js += b" "
    while len(blob) % 4:
        blob.append(0)
    total = 12 + 8 + len(js) + 8 + len(blob)
    with open(path, "wb") as f:
        f.write(struct.pack("<III", _GLB_MAGIC, 2, total))
        f.write(struct.pack("<II", len(js), _CHUNK_JSON))
        f.write(js)
        f.write(struct.pack("<II", len(blob), _CHUNK_BIN))
        f.write(bytes(blob))
