"""The split frame over a mesh of shards (``renderer_tpu.parallel.sharding``).

The JAX package runs one frame plan under ``shard_map`` over a device
mesh: one program drives every device. The port's counterpart is one
process too:

- a ``Mesh`` is a tuple of torch devices, one shard per entry. An entry
  may repeat: ``make_mesh(["cuda:0"] * 2)`` puts two shards on one card,
  as the JAX tests put eight on the CPU (``make_mesh(["cpu"] * 8)``);
- ``run_shards`` runs a function once per shard, each in its own host
  thread, with that shard's ``Shard`` context; the frame plan reads it
  through ``current_shard()``;
- the collectives (``all_gather``, ``psum``, ``halo_rows``) meet in a shared exchange, which every shard calls in the same order.
  The shards take turns: one thread runs at a time, from one collective
  to its next, in shard order, so the threads never contend for the
  interpreter lock (two threads that do, launching a frame's thousands
  of small operations each, ran the split frame 4x slower than one
  shard). Waiting for a turn is a host wait, never a device
  synchronization; each wait has a timeout, and a shard that raises
  releases the others, which raise instead of waiting.

Every shard queues its work on the caller's current stream of each
device, so on one card the shards' work is ordered as the host queued it:
what a shard wrote before a collective is read after it. A tensor handed
to a shard on another card moves by ``Tensor.to``, which orders the copy
after the work queued on both devices' current streams.

This is how the eager split frame runs (``Renderer(..., replay=False)``)
and how the frame program captures it once (``runtime/program.py``):
given ``segments``, ``run_shards`` has each shard's thread end a captured
segment before every collective and begin the next one after it, and the
exchange keeps the values it hands over. Later frames are replays of those
segments from the caller's thread, with no shard thread.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time

import torch

from renderer_tpu_torch.utils import tree

TIMEOUT_S = 300.0  # seconds a shard waits at a collective (and the frame for its shards)

_local = threading.local()


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One shard per entry of ``devices`` (torch devices, repeats allowed)."""

    devices: tuple

    def __len__(self) -> int:
        return len(self.devices)


def make_mesh(devices=None) -> Mesh:
    """A mesh over ``devices`` (names or torch devices), by default every
    CUDA device. The CPU is used only when named."""
    if devices is None:
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError("no CUDA device: name the mesh's devices, e.g. "
                               "make_mesh(['cpu'] * 8)")
    devices = tuple(torch.device(d) for d in devices)
    # "cuda" -> "cuda:0", so a mesh's devices compare with tensors' devices
    devices = tuple(torch.device("cuda", torch.cuda.current_device())
                    if d.type == "cuda" and d.index is None else d for d in devices)
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return Mesh(devices)


class ShardAborted(RuntimeError):
    """Raised in a shard that another shard's failure or timeout released."""


class _Exchange:
    """Where the shards' collectives meet, and whose turn it is. A shard
    puts its value of collective r and hands the turn to the next shard;
    when the turn comes back round, every shard has put its value of r."""

    def __init__(self, n: int, timeout: float, segments=None):
        self.n, self.timeout, self.segments = n, timeout, segments
        self.cond = threading.Condition()
        self.turn = 0
        self.rounds = []  # per collective: every shard's value, and how many have read them
        self.done = [False] * n
        self.error = None  # what released the shards, once one failed

    def _pass_turn(self, i: int) -> None:
        """Hand the turn to the next shard still running (cond held)."""
        for k in range(1, self.n + 1):
            j = (i + k) % self.n
            if not self.done[j]:
                break
        self.turn = j
        self.cond.notify_all()

    def wait_turn(self, i: int) -> None:
        with self.cond:
            if not self.cond.wait_for(lambda: self.turn == i or self.error is not None,
                                      self.timeout):
                self.error = ShardAborted(f"shard {i} of {self.n} waited more than "
                                          f"{self.timeout} s for its turn")
                self.cond.notify_all()
            if self.error is not None:
                raise self.error if isinstance(self.error, ShardAborted) else ShardAborted(
                    f"another shard failed: {self.error!r}")

    def swap(self, i: int, r: int, value) -> list:
        """Put ``value`` as shard i's of collective r; every shard's value,
        once the turn is back."""
        with self.cond:
            if r == len(self.rounds):
                self.rounds.append([[None] * self.n, 0])
            self.rounds[r][0][i] = value
            self._pass_turn(i)
        self.wait_turn(i)
        values = self.rounds[r][0]
        self.rounds[r][1] += 1
        if self.rounds[r][1] == self.n:  # read by all: let the values go (a capture keeps them)
            if self.segments is not None:
                self.segments.keep(values)
            self.rounds[r][0] = None
        return values

    def finish(self, i: int) -> None:
        with self.cond:
            self.done[i] = True
            self._pass_turn(i)

    def abort(self, error: BaseException) -> None:
        with self.cond:
            self.error = self.error or error
            self.cond.notify_all()


class Shard:
    """One shard's view of the split frame: its index on the mesh, the
    shard count and the collectives of ``jax.lax`` that the JAX plan uses,
    on tensors on this shard's device."""

    def __init__(self, index: int, mesh: Mesh, exchange: _Exchange):
        self.index = index
        self.mesh = mesh
        self.device = mesh.devices[index]
        self._exchange = exchange
        self._round = 0  # collectives called so far

    def axis_index(self) -> int:
        return self.index

    def axis_size(self) -> int:
        return len(self.mesh)

    def _swap(self, value) -> list:
        """Every shard's ``value`` of this collective; under a capture the
        shard's segment ends before and the next one begins after."""
        self._round += 1
        segments = self._exchange.segments
        if segments is not None:
            segments.end(self.index)
        values = self._exchange.swap(self.index, self._round - 1, value)
        if segments is not None:
            segments.begin(self.index)
        return values

    def _out(self, value):
        """A collective's result, kept by a capture."""
        if self._exchange.segments is not None:
            self._exchange.segments.keep(value)
        return value

    def all_gather(self, x):
        """Every shard's ``x`` joined along dim 0 in shard order; ``x`` may
        be a container of tensors (``utils.tree``), gathered leaf by leaf in
        one exchange. A 0-dim leaf is returned as it is, as the JAX plan's
        ``_gather`` does."""
        leaves, structure = tree.flatten(x)
        parts = self._swap(leaves)
        return self._out(tree.unflatten(structure, [
            leaf if leaf.dim() == 0 else torch.cat([p[k].to(self.device) for p in parts], dim=0)
            for k, leaf in enumerate(leaves)]))

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of every shard's ``x``, added in shard order."""
        parts = self._swap(x)
        total = parts[0].to(self.device)
        for p in parts[1:]:
            total = total + p.to(self.device)
        return self._out(total)

    def halo_rows(self, *arrays) -> list:
        """Per (..., H, W) array, (the row above its first, the row below
        its last): the last row of the shard above and the first row of the
        shard below, which hold the neighbouring rows of the whole image.
        The top shard's above and the bottom shard's below are its own
        first and last row (the clamp of the whole image's edge). The two
        ``ppermute``s of the JAX package's ``_halo_rows`` in one exchange."""
        own = [(a[..., :1, :], a[..., -1:, :]) for a in arrays]
        parts = self._swap(own)
        i, last = self.index, len(self.mesh) - 1
        return self._out([(up if i == 0 else parts[i - 1][k][1].to(self.device),
                 dn if i == last else parts[i + 1][k][0].to(self.device))
                for k, (up, dn) in enumerate(own)])


def current_shard():
    """The ``Shard`` of the calling thread inside ``run_shards``, else None."""
    return getattr(_local, "shard", None)


def _streams(devices) -> list:
    """The calling thread's current stream on each CUDA device of the mesh."""
    seen = []
    for d in devices:
        if d.type == "cuda" and d not in seen:
            seen.append(d)
    return [torch.cuda.current_stream(d) for d in seen]


def run_shards(mesh: Mesh, fn, timeout: float = TIMEOUT_S, segments=None) -> list:
    """``fn(shard)`` for every shard of ``mesh``, each in its own thread on
    the caller's current streams, its shard's device current, the shards
    taking turns between collectives. Returns the results in shard order.
    If a shard raises, the others are released from their collectives and
    the first shard's error is raised; a shard that waits more than
    ``timeout`` seconds for its turn, or a frame whose shards do not all
    finish within it, raises TimeoutError. With ``segments``
    (``runtime.program.Segments``) every shard's work is captured, one
    segment per stretch between collectives."""
    n = len(mesh)
    exchange = _Exchange(n, timeout, segments)
    streams = _streams(mesh.devices)
    results, errors = [None] * n, [None] * n

    def work(i: int) -> None:
        shard = Shard(i, mesh, exchange)
        _local.shard = shard
        try:
            exchange.wait_turn(i)
            with contextlib.ExitStack() as stack:
                # the shard's own device last: entering a stream makes its device current
                for s in sorted(streams, key=lambda s: s.device == shard.device):
                    stack.enter_context(torch.cuda.stream(s))
                if segments is not None:
                    segments.begin(i)
                results[i] = fn(shard)
                if segments is not None:
                    segments.end(i)
            exchange.finish(i)
        except BaseException as e:  # noqa: BLE001 - handed to the caller below
            if segments is not None:
                segments.abandon(i)
            errors[i] = e
            exchange.abort(e)
        finally:
            _local.shard = None

    threads = [threading.Thread(target=work, args=(i,), name=f"shard-{i}", daemon=True)
               for i in range(n)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + timeout
    for i, t in enumerate(threads):
        t.join(max(0.0, deadline - time.monotonic()))
        if t.is_alive():
            exchange.abort(ShardAborted(f"shard {i} of {n} did not finish within {timeout} s"))
            raise TimeoutError(f"shard {i} of {n} did not finish within {timeout} s")
    first = next((e for e in errors if e is not None and not isinstance(e, ShardAborted)), None)
    if first is not None:
        raise first
    aborted = next((e for e in errors if e is not None), None)
    if aborted is not None:
        raise TimeoutError(str(aborted)) from aborted
    return results


def render_frame_spmd(scene, camera, mesh: Mesh, width: int, height: int,
                      tri_capacity_per_device: int = 2048, shading: str = "pbr",
                      background=(0.05, 0.05, 0.08), **switches):
    """One frame through the split plan (the tile raster, as the JAX
    function forces the Pallas one). Returns (image, depth, tri_id): the
    image gathered, depth and tri_id joined over the shards' rows."""
    from renderer_tpu_torch.passes.pipeline import PipelineConfig
    from renderer_tpu_torch.runtime import Renderer

    n = len(mesh)
    cfg = PipelineConfig(width=width, height=height, tri_capacity=tri_capacity_per_device * n,
                         shading=shading, background=background, tile_raster=True,
                         spmd_devices=n)
    r = Renderer(scene, cfg, outputs=("image", "vis"), spmd_mesh=mesh)
    if switches:
        r.set_config(**switches)
        r.apply_config_now()
    out = r.render(camera)
    return out["image"], out["vis"].depth, out["vis"].tri_id
