"""The frame trace (``utils/profiling.py``'s ``FrameTrace``, switched by
``Renderer.trace_frames(capacity)``).

On the CPU a stamp is the host clock at a span's bound, so the plumbing the
card uses is held here: every pass of eager and replayed frames in plan
order with its frame's id, the shadow pass's sub-spans inside it, the
ring's wrap, the host spans joined to the stamps by frame id, the switch
dropping the programs, nothing recorded with the trace off, one ring per
shard of the split frame, the tracks in ``trace()``'s ``trace.json``, the
clock's interpolation between anchors, and ``summary`` and ``metrics``
over records made by hand (a frame left out, set-up bodies).

The card tests (``-m gpu``, skipped without a CUDA device): a capture with
the trace off holds no stamp kernel, and replayed frames stamp every pass
inside the graph, covering the frame:

    python -m pytest tests/test_torch_frame_trace.py -m gpu -q
"""

import dataclasses
import inspect
import json

import pytest
import torch

from renderer_tpu_torch.mathx import Camera, orbit_camera
from renderer_tpu_torch.models import sponza_like_scene, textured_scene
from renderer_tpu_torch.parallel import make_mesh
from renderer_tpu_torch.passes.pipeline import PipelineConfig
from renderer_tpu_torch.runtime import Renderer, frame
from renderer_tpu_torch.scene import SceneLimits
from renderer_tpu_torch.utils import profiling

W, H = 64, 32
# the dynamic tier's cache: one band of two per frame on the sun's slot
CFG = PipelineConfig(width=W, height=H, tri_capacity=512, aa="edge", trilinear=False,
                     shadow_size=128, shadow_update_budget=1, shadow_progressive=2,
                     shadow_slots=1)
SHADOW_SUBSPANS = ("shadow.lights", "shadow.signature", "shadow.slots", "shadow.stack")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite's workers share the host's cores
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    return textured_scene(SceneLimits.tiny(), 32, device="cpu")


def cam(k: int) -> Camera:
    return Camera.create([0.15 * k, 1.2, 4.0], fov_y=0.9, near=0.1, far=60.0, aspect=W / H,
                         device="cpu")


def traced(r: Renderer, capacity: int) -> Renderer:
    r.trace_frames(capacity)
    return r


def shadowed(scene, cfg=CFG, **kw) -> Renderer:
    r = Renderer(scene, cfg, **kw)
    r.set_config(shadows=True)
    r.apply_config_now()
    return r


def plan_names(r: Renderer) -> list:
    return [p.name for p in r.passes]


def by_begin(spans: dict) -> list:
    return [n for n, _ in sorted(spans.items(), key=lambda kv: kv[1])]


@pytest.mark.parametrize("replay", [False, True], ids=["eager", "replay"])
def test_every_pass_in_plan_order_with_its_frame(scene, replay):
    r = traced(shadowed(scene, replay=replay), 8)
    for k in range(3):
        r.render(cam(k))
    rec = r.frame_trace.read()
    assert rec["frames"] == [0, 1, 2] and rec["counters"]["frames"] == 3
    passes = plan_names(r)
    for f in rec["frames"]:
        spans = rec["device"][0][f]
        got = [n for n in by_begin(spans) if n in passes]
        assert got == passes, f"frame {f}"
        assert all(b <= e for b, e in spans.values())
        # the donation follows the last pass of a program's frame
        assert ("donate" in spans) == replay
        if replay:
            assert by_begin(spans)[-1] == "donate"
            assert spans["donate"][0] >= spans[passes[-1]][1]


def test_shadow_subspans_nest_in_the_shadow_pass(scene):
    r = traced(shadowed(scene, replay=True), 4)
    for k in range(2):
        r.render(cam(k))
    rec = r.frame_trace.read()
    for f in rec["frames"]:
        spans = rec["device"][0][f]
        b, e = spans["shadow_pass"]
        subs = [spans[n] for n in SHADOW_SUBSPANS]
        assert all(b <= s0 <= s1 <= e for s0, s1 in subs)
        assert all(a[1] <= c[0] for a, c in zip(subs, subs[1:]))  # in order, apart


def test_ring_wraps_at_its_capacity(scene):
    r = traced(Renderer(scene, CFG, replay=True), 2)
    for k in range(5):
        r.render(cam(k))
    rec = r.frame_trace.read()
    assert rec["frames"] == [3, 4] and rec["counters"]["frames"] == 5
    assert set(rec["device"][0]) == {3, 4}
    assert all(rec["device"][0][f] for f in (3, 4))
    assert {f for f, *_ in rec["host"]} == {3, 4}
    # each cell of the ring names the frame that wrote it
    ring = r.frame_trace.rings[0]
    used = ring[..., 0] >= 0
    assert set(ring[..., 0][used].tolist()) == {3, 4}
    assert torch.equal(ring[4 % 2, :, 0][used[0]], torch.full_like(ring[0, :, 0][used[0]], 4))


def test_host_spans_and_stamps_join_on_the_frame(scene):
    r = traced(shadowed(scene, replay=True), 4)
    lights = scene.lights
    for k in range(3):  # another light table of the same lights: the host checks it
        r.render(cam(k), scene=scene._replace(lights=lights._replace(
            position=lights.position.clone())))
    rec = r.frame_trace.read()
    for f in rec["frames"]:
        host = {n: (b, e) for g, n, b, e in rec["host"] if g == f}
        assert {"render.check_lights", "copy_in", "launch", "copy_out", "tail"} <= set(host)
        order = ["render.check_lights", "copy_in", "launch", "copy_out", "tail"]
        assert [n for n, _ in sorted(host.items(), key=lambda kv: kv[1]) if n in order] == order
        # on the CPU the frame's work is done inside its launch: one clock
        lo, hi = host["launch"]
        first, last = profiling.frame_bounds(rec, f)
        assert lo <= first <= last <= hi, f"frame {f}"


def test_switching_the_trace_drops_the_programs(scene):
    r = Renderer(scene, CFG, replay=True)
    r.render(cam(0))
    assert len(r.programs) == 1 and r.frame_trace is None
    r.trace_frames(4)
    assert not r.programs and r.frame_trace.capacity == 4
    r.render(cam(1))
    (program,) = r.programs.values()
    assert program.trace is r.frame_trace
    r.trace_frames(0)
    assert not r.programs and r.frame_trace is None
    r.render(cam(2))
    (program,) = r.programs.values()
    assert program.trace is None


def test_trace_off_records_nothing(scene, monkeypatch):
    assert inspect.signature(frame.execute_plan).parameters["wrap"].default is frame._record_pass

    def refuse(*args, **kw):
        raise AssertionError("a frame without the trace recorded")

    for name in ("mark", "flush", "host"):
        monkeypatch.setattr(profiling.FrameTrace, name, refuse)
    from torch.profiler import ProfilerActivity, profile

    for replay in (False, True):
        r = shadowed(scene, replay=replay)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            r.render(cam(0))
        names = {e.name for e in prof.events()}
        # the passes' profiler ranges, as without the trace ever
        assert {f"forward.{p}" for p in plan_names(r)} <= names
        assert r.frame_trace is None and not profiling._ACTIVE


@pytest.mark.parametrize("replay", [False, True], ids=["eager", "replay"])
def test_split_frame_records_each_shard(scene, replay):
    r = traced(Renderer(scene, dataclasses.replace(CFG, spmd_devices=2),
                        spmd_mesh=make_mesh(["cpu"] * 2), replay=replay), 4)
    for k in range(2):
        r.render(cam(k))
    rec = r.frame_trace.read()
    assert len(rec["device"]) == 2 and len(r.frame_trace.rings) == 2
    passes = plan_names(r)
    for per in rec["device"]:
        for f in (0, 1):
            assert [n for n in by_begin(per[f]) if n in passes] == passes


def test_trace_json_holds_the_program_tracks(scene, tmp_path):
    r = traced(Renderer(scene, CFG, replay=True), 4)
    with profiling.trace(str(tmp_path)) as log_dir:
        for k in range(2):
            r.render(cam(k))
    with open(f"{log_dir}/trace.json") as f:
        events = json.load(f)["traceEvents"]
    ours = [e for e in events if e.get("cat") == "frame_trace"]
    names = {e["name"] for e in ours}
    assert {"cull", "raster", "donate", "copy_in", "launch", "copy_out"} <= names
    assert {e["args"]["frame"] for e in ours} == {0, 1}
    meta = [e["args"]["name"] for e in events if e.get("ph") == "M"
            and e.get("pid") == profiling.TRACK_PID]
    assert "host spans" in meta and any(m.startswith("device spans, shard 0") for m in meta)
    # on the profiler's clock: beside the passes' own profiler ranges
    cull = next(e for e in ours if e["name"] == "cull" and e["args"]["frame"] == 0)
    ranges = [e for e in events if e.get("name") == "forward.cull"]
    assert any(abs(e["ts"] - cull["ts"]) < 5e3 for e in ranges)


def test_clock_maps_between_anchors():
    # the second clock runs 10 ppm fast and starts 1000 ns ahead
    anchors = [(0, 1000), (10**9, 10**9 + 1000 + 10**4)]
    got = profiling._map([0, 5 * 10**8, 10**9, 2 * 10**9, -10], anchors)
    assert got.tolist() == [1000, 5 * 10**8 + 6000, 10**9 + 11000, 2 * 10**9 + 11000, 990]
    assert profiling._map([7], [(5, 12)]).tolist() == [14]


def test_summary_of_a_record():
    ms = 10**6
    dev = {0: {"cull": (0, 2 * ms), "shadow_pass": (2 * ms, 6 * ms), "donate": (6 * ms, 7 * ms)},
           1: {"cull": (8 * ms, 10 * ms), "shadow_pass": (11 * ms, 13 * ms),
               "donate": (13 * ms, 14 * ms)}}
    rec = {"frames": [0, 1], "device": [dev],
           "host": [(0, "copy_in", 0, ms), (1, "copy_in", 0, 3 * ms), (1, "launch", 0, ms)],
           "counters": {"frames": 4, "bodies_run": 2, "pool_bytes": [5, 7]}}
    s = profiling.summary(rec)
    assert s["frames"] == 2
    assert s["host_ms"] == {"copy_in": 2.0, "launch": 0.5}
    assert s["device_ms"] == {"cull": 2.0, "shadow_pass": 3.0, "donate": 1.0}
    assert s["donate_ms"] == 1.0
    assert s["frame_gap_pct"] == pytest.approx(100.0 * ms / (14 * ms))
    assert s["cover_pct"] == pytest.approx(100.0 * 5 / 6)  # frame 1: 10-11 ms uncovered
    assert s["bodies_per_frame"] == 0.5 and s["pool_bytes"] == 7
    empty = profiling.summary({"frames": [], "device": [{}], "host": [],
                               "counters": {"frames": 0, "bodies_run": 0, "pool_bytes": []}})
    assert empty["donate_ms"] is None and empty["frame_gap_pct"] is None
    assert empty["bodies_per_frame"] is None and empty["pool_bytes"] is None
    assert empty["cover_pct"] is None and empty["device_ms"] == {}


def test_summary_leaves_out_skipped_frames_and_set_up_bodies():
    """A frame left out (frame 2, a profiled stretch's) ends a run of
    frames: neither the gaps around it nor its time count. Bodies per frame
    count from ``since``, the counters at the window's start, so the
    set-up's bodies are left out. ``metrics`` gives the benchmark's names,
    None where the record holds nothing."""
    ms = 10**6
    dev = {0: {"cull": (0, 2 * ms)}, 1: {"cull": (3 * ms, 5 * ms)},
           2: {"cull": (6 * ms, 100 * ms)}, 3: {"cull": (101 * ms, 103 * ms)},
           4: {"cull": (104 * ms, 106 * ms), "shadow.slots": (105 * ms, 106 * ms)}}
    rec = {"frames": [0, 1, 2, 3, 4], "device": [dev],
           "host": [(f, "launch", 0, ms) for f in range(5)] + [(2, "copy_in", 0, 9 * ms)],
           "counters": {"frames": 10, "bodies_run": 261, "pool_bytes": [2**30]}}
    window = [0, 1, 3, 4]
    since = {"frames": 5, "bodies_run": 256}
    s = profiling.summary(rec, window, since)
    assert s["frame_gap_pct"] == pytest.approx(100.0 * 2 / 10)  # 1 + 1 ms over 5 + 5 ms
    assert s["bodies_per_frame"] == 1.0
    assert profiling.summary(rec, window)["bodies_per_frame"] == 26.1
    m = profiling.metrics(rec, window, since)
    assert m == {"copy_in_ms": None, "launch_ms": 1.0, "copy_out_ms": None, "host_wait_ms": 0.0,
                 "cull_replay_ms": 2.0, "raster_replay_ms": None, "shade_replay_ms": None,
                 "shadow_signature_ms": None, "shadow_slots_ms": 1.0, "shadow_stack_ms": None,
                 "donate_ms": None, "frame_gap_pct": s["frame_gap_pct"],
                 "shadow_bands_per_frame": 1.0, "graph_pool_gib": 1.0}


# -- on the card ------------------------------------------------------------------------------
CARD_CFG = PipelineConfig(width=256, height=128, tri_capacity=8192, aa="edge", trilinear=False,
                          shadow_size=256, shadow_update_budget=1, shadow_progressive=2)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_trace_off_capture_holds_no_stamp():
    dev = _card()
    stamp = profiling._stamp_kernel()
    stamp.launches = 0
    r = shadowed(sponza_like_scene(256, device=dev), CARD_CFG)
    for k in range(4):
        r.render(orbit_camera(0.3 + 0.01 * k, 2.0, dev))
    torch.cuda.synchronize()
    assert r.stats["compiles"] == 1 and stamp.launches == 0


@pytest.mark.gpu
@pytest.mark.parametrize("replay", [False, True], ids=["eager", "replay"])
def test_frames_on_the_card_stamp_every_pass(replay):
    dev = _card()
    r = traced(shadowed(sponza_like_scene(256, device=dev), CARD_CFG, replay=replay), 16)
    for k in range(6):
        r.render(orbit_camera(0.3 + 0.01 * k, 2.0, dev))
    torch.cuda.synchronize()
    rec = r.frame_trace.read()
    passes = plan_names(r)
    s = profiling.summary(rec, frames=range(1, 6))
    print(json.dumps(s))
    for f in range(1, 6):
        spans = rec["device"][0][f]
        assert [n for n in by_begin(spans) if n in passes] == passes, f"frame {f}"
        host = {n: (b, e) for g, n, b, e in rec["host"] if g == f}
        if replay:
            # the graph runs after its copy-in on the host (one clock; 50 us for the anchors)
            assert profiling.frame_bounds(rec, f)[0] >= host["copy_in"][0] - 50_000
        sub = sum(spans[n][1] - spans[n][0] for n in SHADOW_SUBSPANS)
        whole = spans["shadow_pass"][1] - spans["shadow_pass"][0]
        print(f, whole, sub)
    assert s["cover_pct"] >= 95.0
    assert (r.stats["compiles"] == 1) == replay


@pytest.mark.gpu
def test_trace_json_stamps_sit_on_their_kernels(tmp_path):
    """In ``trace()``'s export each stamp of the frame trace's tracks lies
    within 20 us of its own stamp kernel's interval (the k-th in time
    against the k-th, the anchors' kernels left out)."""
    dev = _card()
    r = traced(shadowed(sponza_like_scene(256, device=dev), CARD_CFG), 16)
    r.render(orbit_camera(0.3, 2.0, dev))  # the capture, outside the profile
    with profiling.trace(str(tmp_path)) as log_dir:
        for k in range(1, 5):
            r.render(orbit_camera(0.3 + 0.01 * k, 2.0, dev))
    with open(f"{log_dir}/trace.json") as f:
        events = json.load(f)["traceEvents"]
    anchors = [(e["ts"], e["ts"] + e["dur"]) for e in events
               if e.get("name", "").startswith(profiling.ANCHOR_RANGE)]
    in_anchor = {e["args"].get("correlation") for e in events if e.get("cat") == "cuda_runtime"
                 and any(lo <= e["ts"] <= hi for lo, hi in anchors)}
    kernels = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                     if e.get("cat") == "kernel" and "stamp_kernel" in e.get("name", "")
                     and e["args"].get("correlation") not in in_anchor)
    ours = [e for e in events if e.get("cat") == "frame_trace" and e.get("tid") == 0
            and e.get("pid") == profiling.TRACK_PID]
    # a boundary between two spans is one stamp
    stamps = sorted({round(t, 3) for e in ours for t in (e["ts"], e["ts"] + e["dur"])})
    assert len(stamps) == len(kernels) > 0
    worst = max(max(0.0, lo - t, t - hi) for t, (lo, hi) in zip(stamps, kernels))
    print(f"{len(stamps)} stamps, worst {worst:.2f} us outside their kernels")
    assert worst <= 20.0
