"""Scene streaming (``renderer_tpu.runtime.streaming``): decode on host
threads, upload into the live scene on a per-frame budget.

Decoding (a glTF parse, normal generation, a texture's resize and mips)
runs in a ``ThreadPoolExecutor``. ``pump()`` integrates at most ``budget``
decoded items per frame by writing the scene's tensors in place, in
fixed-size chunks (meshes larger than a chunk loop over consecutive
chunks), so the scene object a ``Renderer`` holds sees them.

On a CUDA device every upload stages through page-locked memory: the
``Arena`` when one is given (page-locked at its creation), else
``torch.empty(..., pin_memory=True)``; the copies to the card are
asynchronous, on the current stream, so each write is ordered after the
previous frame's reads of the same tensors, and no upload waits for the
card. Scalars (a mesh's directory row, a spawned instance, its box) go in
as device fills or as one row from pinned memory. An arena block is freed two
pumps after its upload, and never before the CUDA event recorded after
its copies has completed (``query()`` in ``pump``; ``close()`` waits).

The counts the streamer raises (``mesh_count``, ``tri_count``,
``vertex_count``, ``instances.count``) change on the device only; the
streamer keeps its own host offsets.
"""

from __future__ import annotations

from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np
import torch

from renderer_tpu_torch.scene.builder import HostMesh
from renderer_tpu_torch.scene.textures import build_mips
from renderer_tpu_torch.scene.types import CL_COLS, CLUSTER, MeshLibrary, Scene
from renderer_tpu_torch.utils.image import resize_bilinear_u8

# streamed meshes upload in chunks of these many rows at most (the JAX
# package's compiled-program sizes; kept so the tables written match it)
CHUNK_VERTS = 4096
CHUNK_TRIS = 8192


def _cluster_rows(v: torch.Tensor, rm: torch.Tensor) -> torch.Tensor:
    """(ncl, CL_COLS) cluster rows (bounding sphere, normal cone, real
    count) of (ncl, CLUSTER, 3, 3) triangle corners, ``rm`` (ncl, CLUSTER)
    marking the real (non-padding) triangles; the builder's
    ``compute_cluster_data`` in float32 torch."""
    ncl = v.shape[0]
    fn = torch.linalg.cross(v[:, :, 1] - v[:, :, 0], v[:, :, 2] - v[:, :, 0], dim=-1)
    ln = torch.linalg.norm(fn, dim=-1)
    ok_n = rm & (ln > 1e-12)
    n_unit = fn / ln.clamp(min=1e-12)[..., None]
    wv = rm[:, :, None].expand(ncl, CLUSTER, 3).reshape(ncl, CLUSTER * 3, 1)
    verts = v.reshape(ncl, CLUSTER * 3, 3)
    center = (verts * wv).sum(dim=1) / wv.sum(dim=1).clamp(min=1)
    radius = torch.sqrt(torch.where(wv[..., 0], ((verts - center[:, None]) ** 2).sum(-1),
                                    0.0).amax(dim=1))
    axis = (n_unit * ok_n[..., None]).sum(dim=1)
    alen = torch.linalg.norm(axis, dim=-1)
    axis = axis / alen.clamp(min=1e-12)[:, None]
    cosang = torch.where(ok_n, (n_unit * axis[:, None]).sum(-1), 1.0).amin(dim=1)
    degenerate = (rm & ~ok_n).any(dim=1) | (alen < 1e-6) | (cosang < 0.1)
    cosang = cosang.clamp(-1.0, 1.0)
    sinang = torch.sqrt((1.0 - cosang * cosang).clamp(min=0.0))
    return torch.cat([
        center, radius[:, None], axis,
        torch.where(degenerate, -1.0, cosang)[:, None],
        torch.where(degenerate, 2.0, sinang)[:, None],
        rm.sum(dim=1).to(torch.float32)[:, None],  # CL_COUNT
        torch.zeros((ncl, CL_COLS - 10), dtype=torch.float32, device=v.device),
    ], dim=1)


def _upload_vert_chunk(lib: MeshLibrary, staged: list, v_off: int) -> None:
    """Copy staged (positions, normals, uvs, tangents) rows in at v_off."""
    n = staged[0].shape[0]
    for table, rows in zip((lib.positions, lib.normals, lib.uvs, lib.tangents), staged):
        table[v_off:v_off + n].copy_(rows, non_blocking=True)


def _upload_index_chunk(lib: MeshLibrary, staged: torch.Tensor, t_off: int, n_real: int) -> None:
    """Copy staged index rows in at t_off and refresh their ``tri_rec``
    rows (gathered as the builder gathers them, so a streamed mesh's
    records equal a built scene's bit for bit) and ``cluster_data`` rows:
    the mesh's vertex chunks landed first. Rows past n_real are range
    padding (degenerate). Chunks are CLUSTER-aligned when they can be."""
    nrows = staged.shape[0]
    idx = lib.indices[t_off:t_off + nrows]
    idx.copy_(staged, non_blocking=True)
    real = torch.arange(nrows, device=idx.device) < n_real
    g = idx.long()
    if lib.tri_rec is not None:
        rows = torch.cat([lib.positions[g].reshape(nrows, 9), lib.normals[g].reshape(nrows, 9),
                          lib.uvs[g].reshape(nrows, 6), lib.tangents[g].reshape(nrows, 12)], dim=1)
        lib.tri_rec[t_off:t_off + nrows] = torch.where(real[:, None], rows, 0.0)
    if lib.cluster_data is not None and nrows % CLUSTER == 0:
        ncl = nrows // CLUSTER
        lib.cluster_data[t_off // CLUSTER:t_off // CLUSTER + ncl] = _cluster_rows(
            lib.positions[g].reshape(ncl, CLUSTER, 3, 3), real.reshape(ncl, CLUSTER))


class SceneStreamer:
    """Streams meshes and textures into a live Scene with a per-frame
    upload budget. Reads the scene's counts on the host once, at
    construction (between frames)."""

    def __init__(self, scene: Scene, budget: int = 8, workers: int = 2, arena=None):
        self.scene = scene
        self.budget = budget  # at most this many uploads per pump
        self.device = scene.meshes.positions.device
        self._pool = ThreadPoolExecutor(max_workers=workers)
        self._pending: list[Future] = []
        self._ready: list[tuple] = []
        self._v_off = int(scene.meshes.vertex_count)
        self._t_off = int(scene.meshes.tri_count)
        self._mesh_slot = int(scene.meshes.mesh_count)
        self._inst_slot = int(scene.instances.count)
        self.arena = arena
        # arena blocks of the previous pump and of this one, each batch with
        # the event recorded after its copies; older batches wait in _held
        # until their event has completed
        self._deferred: list[list[np.ndarray]] = [[], []]
        self._events: list = [None, None]
        self._held: list[tuple] = []
        # texture layer slots: bump allocation from the scene's committed
        # count, with a free list so released layers recycle
        atlas = scene.atlas
        self._committed_layers = int(atlas.n_layers)
        self._next_tex_layer = self._committed_layers
        self._free_tex_layers: list[int] = []
        self._level_offset = [int(x) for x in atlas.level_offset.tolist()]
        self._level_size = [int(x) for x in atlas.level_size.tolist()]
        self.stats = {"requested": 0, "decoded": 0, "uploaded": 0, "frames": 0, "chunks": 0}

    # -- producers ----------------------------------------------------------
    def request_mesh(self, source, material_id=0, translation=(0, 0, 0),
                     rotation=(1, 0, 0, 0), scale=1.0) -> None:
        """source: a HostMesh, a path to a .glb/.gltf (its first mesh,
        parsed in the worker thread), or a zero-argument callable returning
        a HostMesh."""
        self.stats["requested"] += 1

        def decode():
            if isinstance(source, HostMesh):
                mesh = source
            elif callable(source):
                mesh = source()
            else:
                from renderer_tpu_torch.scene import SceneBuilder, SceneLimits
                from renderer_tpu_torch.scene.gltf import load_gltf

                # the default limits: a committed asset (colonnade.glb, 242
                # instances) overflows tiny()'s instance table
                mesh = load_gltf(str(source), SceneBuilder(SceneLimits()))._meshes[0]
            return (mesh, material_id, translation, rotation, scale)

        self._pending.append(self._pool.submit(decode))

    # -- per-frame integration ----------------------------------------------
    def pump(self) -> Scene:
        """Integrate up to ``budget`` decoded items; returns the live scene
        (the same object, written in place)."""
        self.stats["frames"] += 1
        if self.arena is not None:
            self._held.append((self._deferred.pop(0), self._events.pop(0)))
            self._deferred.append([])
            self._events.append(None)
            self._held = [(blocks, ev) for blocks, ev in self._held
                          if not self._free_if_drained(blocks, ev)]
        still = []
        for f in self._pending:
            if f.done():
                self._ready.append(f.result())
                self.stats["decoded"] += 1
            else:
                still.append(f)
        self._pending = still

        for _ in range(min(self.budget, len(self._ready))):
            item = self._ready.pop(0)
            if item[0] == "texture":
                self._upload_texture(item[1], item[2])
            else:
                self._upload(*item)
            self.stats["uploaded"] += 1
        return self.scene

    def _free_if_drained(self, blocks: list, event) -> bool:
        if event is not None and not event.query():
            return False
        for blk in blocks:
            self.arena.free(blk)
        return True

    # -- staging ------------------------------------------------------------
    def _stage(self, a: np.ndarray, n: int, tail: tuple) -> torch.Tensor:
        """A zero-padded (n, *tail) host copy of ``a`` to copy from: an arena
        block when there is an arena (freed later), pinned memory for the
        card without one."""
        if self.arena is not None:
            buf = self.arena.alloc((n,) + tail, a.dtype)
            self._deferred[-1].append(buf)
            staged = torch.from_numpy(buf)
        elif self.device.type == "cuda":
            staged = torch.empty((n,) + tail, dtype=torch.from_numpy(a[:0]).dtype,
                                 pin_memory=True)
            buf = staged.numpy()
        else:
            buf = np.empty((n,) + tail, a.dtype)
            staged = torch.from_numpy(buf)
        buf[:len(a)] = a
        buf[len(a):] = 0
        return staged

    def _copies_issued(self) -> None:
        """Record, after this pump's copies so far, the event its arena
        blocks wait for."""
        if self.arena is not None and self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
            self._events[-1] = event

    @staticmethod
    def _chunk_for(n, cap_left, biggest):
        """The smallest of the chunk tiers (256, 1024, ``biggest``) >= n that
        fits in cap_left, else an exact CLUSTER-aligned or exact-fit chunk
        (the JAX package's tiers, so the rows written past a mesh match it);
        None when n does not fit."""
        for c in (256, 1024, biggest):
            if n <= c <= cap_left:
                return c
        n32 = -(-n // 32) * 32
        if n32 <= cap_left:
            return n32
        if n <= cap_left:
            return n  # last slots at exact capacity (cluster rows skipped)
        return None

    def _upload(self, mesh: HostMesh, material_id, translation, rotation, scale) -> None:
        v = len(mesh.positions)
        tcnt = len(mesh.indices)
        lib = self.scene.meshes
        v_cap = lib.positions.shape[0]
        t_cap = lib.indices.shape[0]
        tpad = -(-tcnt // 32) * 32  # keep ranges CLUSTER-aligned
        if self._v_off + v > v_cap or self._t_off + tpad > t_cap:
            # an unaligned fit is safe only without cluster tables: a
            # misaligned range would point cluster ids into another mesh's rows
            if lib.cluster_data is None:
                tpad = tcnt
        if self._v_off + v > v_cap or self._t_off + tpad > t_cap:
            raise MemoryError(
                f"mesh library capacity exhausted during streaming "
                f"({v} verts / {tcnt} tris vs {v_cap - self._v_off} / "
                f"{t_cap - self._t_off} left)"
            )

        off = 0
        while off < v:
            n = min(CHUNK_VERTS, v - off)
            chunk = self._chunk_for(n, v_cap - (self._v_off + off), CHUNK_VERTS)
            staged = [self._stage(getattr(mesh, name)[off:off + n], chunk, (width,))
                      for name, width in (("positions", 3), ("normals", 3), ("uvs", 2),
                                          ("tangents", 4))]
            _upload_vert_chunk(lib, staged, self._v_off + off)
            self.stats["chunks"] += 1
            off += n

        idx_global = mesh.indices.astype(np.int32) + self._v_off
        off = 0
        while off < tcnt:
            n = min(CHUNK_TRIS, tcnt - off)
            chunk = self._chunk_for(n, t_cap - (self._t_off + off), CHUNK_TRIS)
            _upload_index_chunk(lib, self._stage(idx_global[off:off + n], chunk, (3,)),
                                self._t_off + off, n)
            self.stats["chunks"] += 1
            off += n

        # the mesh's box and the instance's transform: one row, copied from
        # pinned memory (the caching host allocator's, not the arena's)
        row = torch.from_numpy(np.concatenate([
            mesh.positions.min(axis=0), mesh.positions.max(axis=0),
            np.asarray(translation, np.float32).reshape(3),
            np.asarray(rotation, np.float32).reshape(4),
            np.asarray([scale], np.float32)]).astype(np.float32))
        if self.device.type == "cuda":
            row = row.pin_memory()
        vals = row.to(self.device, non_blocking=True)
        m, slot = self._mesh_slot, self._inst_slot
        # fill_ and copy_, not item assignment: assigning a Python number to
        # a CUDA tensor's element copies a host scalar over and waits
        lib.mesh_vertex_offset[m].fill_(self._v_off)
        lib.mesh_vertex_count[m].fill_(v)
        lib.lod_index_offset[m].fill_(self._t_off)
        lib.lod_tri_count[m].fill_(tcnt)
        lib.mesh_aabb_min[m].copy_(vals[0:3])
        lib.mesh_aabb_max[m].copy_(vals[3:6])
        lib.vertex_count.clamp_(min=self._v_off + v)
        lib.tri_count.clamp_(min=self._t_off + tcnt)
        lib.mesh_count.clamp_(min=m + 1)
        inst = self.scene.instances
        inst.translation[slot].copy_(vals[6:9])
        inst.rotation[slot].copy_(vals[9:13])
        inst.scale[slot].copy_(vals[13])
        inst.mesh_id[slot].fill_(m)
        inst.material_id[slot].fill_(int(material_id))
        inst.alive[slot].fill_(True)
        inst.count.clamp_(min=slot + 1)
        self._copies_issued()
        self._v_off += v
        self._t_off += tpad
        self._mesh_slot += 1
        self._inst_slot += 1

    # -- texture streaming -----------------------------------------------
    def request_texture(self, img) -> int:
        """Queue a texture for upload into a preallocated atlas layer (the
        scene built with ``texture_slots``). Returns the layer id to use in
        materials now; the slot shows white until the upload lands. An
        image of another size is resized to the layer's with Pillow's
        BILINEAR, bit for bit (``resize_bilinear_u8``)."""
        per_layer = sum(s * s for s in self._level_size)
        n_layers = self.scene.atlas.packed_u32.shape[0] // per_layer
        if self._free_tex_layers:
            layer = self._free_tex_layers.pop()
        else:
            layer = self._next_tex_layer
            if layer >= n_layers:
                raise MemoryError(
                    f"atlas layer slots exhausted during streaming "
                    f"({n_layers} total; release_texture recycles slots)"
                )
            self._next_tex_layer += 1
        self.stats["requested"] += 1
        size = self._level_size[0]

        def decode():
            arr = np.asarray(img)
            if arr.dtype != np.uint8:
                arr = np.clip(np.round(arr * 255.0), 0, 255).astype(np.uint8)
            if arr.shape[-1] == 3:
                arr = np.concatenate([arr, np.full(arr.shape[:2] + (1,), 255, np.uint8)], axis=-1)
            if arr.shape[:2] != (size, size):
                arr = resize_bilinear_u8(arr, (size, size))
            words = []
            for m in build_mips(arr):
                p = m.reshape(-1, 4).astype(np.uint32)
                words.append(p[:, 0] | (p[:, 1] << 8) | (p[:, 2] << 16) | (p[:, 3] << 24))
            return ("texture", layer, words)

        self._pending.append(self._pool.submit(decode))
        return layer

    def release_texture(self, layer: int) -> None:
        """Return a streamed layer's slot to the free list. The caller stops
        referencing the layer in materials first; the texels stay until a
        new request overwrites them."""
        if layer < self._committed_layers or layer >= self._next_tex_layer:
            raise ValueError(f"layer {layer} was not streamed by this streamer")
        if layer in self._free_tex_layers:
            raise ValueError(f"layer {layer} already released")
        self._free_tex_layers.append(layer)

    def _upload_texture(self, layer: int, words: list) -> None:
        """Write one texture's mip stack into its layer of ``packed_u32``
        (int32 holding the uint32 bits) from one staged copy. The JAX
        package also refreshes the layer's quad-table rows; the port's
        atlas has none (``scene.textures``)."""
        staged = self._stage(np.concatenate(words).view(np.int32), sum(map(len, words)), ())
        packed = self.scene.atlas.packed_u32
        off = 0
        for lvl, w in enumerate(words):
            start = self._level_offset[lvl] + layer * len(w)
            packed[start:start + len(w)].copy_(staged[off:off + len(w)], non_blocking=True)
            off += len(w)
        self._copies_issued()

    def close(self) -> None:
        """Stop the decode workers and, with an arena, wait for the copies
        and free every staging block."""
        self._pool.shutdown(wait=False)
        if self.arena is not None:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            for blocks in self._deferred + [b for b, _ in self._held]:
                for blk in blocks:
                    self.arena.free(blk)
            self._deferred, self._events, self._held = [[], []], [None, None], []
