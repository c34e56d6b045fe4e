"""Kernel 7, the shading core (``ops/pbr.shade_samples_kernel``,
``csrc/shade.cu``), against its plain version ``shade_samples_plain``
(held to the JAX package by ``tests/test_torch_shade.py``). Free of jax:

    python -m pytest tests/test_torch_shade_kernel.py -m gpu -q

Gates, all bit for bit (``torch.equal``). On the card: the kernel equals
the plain version on the samples it takes (gathered as ``shade_pbr``
gathers them) with barycentrics from the records and given, textures,
normal maps and trilinear filtering each on and off, 1, 2 and all light
slots, a shadowed directional light at 512^2 and 4096^2 slots, a shadowed
point light and none, and traced planes; on the full frame, the
checkerboard and quarter lattices (also of a row band from an odd row),
and a fix's pixel list with samples marked not good; on the edge cases (a
zero edge-function sum, texture layers -1, receivers outside the slot, a
dead light, receivers on cube-face edges); and inside a captured CUDA graph
replayed on new inputs. Whole ``shade_pbr`` frames through the kernel
equal the same frames with the plain version shading every grid, at the
benchmark configurations' options on a small scene, checkerboard+fix and
the other rates. On the CPU: the plain version's lattices and lists land
on the pixels the rebuilds and fixes assume and shade them as the full
frame does; a CPU ``shade_pbr`` neither builds nor loads the kernel.
"""

import math

import pytest
import torch

from renderer_tpu_torch.mathx import Camera
from renderer_tpu_torch.models import shadow_envelope_lights, sponza_like_scene
from renderer_tpu_torch.ops import pbr
from renderer_tpu_torch.ops.geometry import SR_BC_LAYER, SR_EDGE, SR_NM_LAYER
from renderer_tpu_torch.ops.pbr import (SHADE, Lattice, PixelList, ShadeFrame, _sample_geometry,
                                        shade_pbr, shade_samples_kernel, shade_samples_plain_at)
from renderer_tpu_torch.ops.raster_cuda import VisibilityBuffer
from renderer_tpu_torch.passes.pipeline import PipelineConfig
from renderer_tpu_torch.runtime import Renderer
from renderer_tpu_torch.scene import SceneLimits

W, H = 256, 128
POS = [6.0, 8.0, 14.0]
PITCH = -0.4  # the horizon in view: uncovered samples at the top
BG = (0.05, 0.05, 0.08)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def camera(device, w=W, h=H, pos=POS):
    return Camera.create(pos, rotation=[math.cos(PITCH / 2), math.sin(PITCH / 2), 0.0, 0.0],
                         fov_y=0.9, near=0.1, far=60.0, aspect=w / h, device=device)


def render(scene, cfg, device, pos=POS):
    """One eager shadowed frame: (its outputs, the camera, the renderer)."""
    r = Renderer(scene, cfg, outputs=("vis", "shade_rec", "prepared", "shadow"), replay=False)
    r.set_config(shadows=True)
    r.apply_config_now()
    cam = camera(device, cfg.width, cfg.height, pos)
    return r.render(cam), cam, r


_FRAMES = {}


def frame_inputs(device, shadow_size: int, point=None):
    """The sponza scene of 64 instances at 256x128 with its directional
    light in shadow slot 0 and its point light in slot 1 (at ``point``, or
    where the scene puts it): the visibility buffer, records, camera and
    shadow maps of one frame (cached)."""
    key = (str(device), shadow_size, point)
    if key not in _FRAMES:
        scene = sponza_like_scene(64, device=device)
        ids = torch.arange(scene.lights.alive.shape[0], device=device)
        lights = scene.lights._replace(shadow_slot=torch.where(ids < 2, ids, -1).to(torch.int32))
        if point is not None:
            pos = lights.position.clone()
            pos[1] = torch.tensor(point, device=device)
            lights = lights._replace(position=pos)
        scene = scene._replace(lights=lights)
        cfg = PipelineConfig(width=W, height=H, tri_capacity=4096, enable_normal_maps=True,
                             trilinear=False, shadow_slots=2, shadow_size=shadow_size,
                             shadow_cache=False)
        out, cam, _ = render(scene, cfg, device)
        _FRAMES[key] = (scene, out, cam)
    return _FRAMES[key]


def make_frame(scene, out, cam, vis, y0=0, **kw):
    opts = dict(enable_textures=True, enable_normal_maps=True, trilinear=False,
                n_lights=scene.lights.alive.shape[0], shadow=out["shadow"], traced_casts=None)
    opts.update(kw)
    dev = vis.depth.device
    bg = torch.stack([torch.full((1, 1), c, dtype=torch.float32, device=dev) for c in BG])
    return ShadeFrame(out["shade_rec"], scene.atlas, scene.lights, cam.position,
                      out["prepared"].vp_inv, W, H, y0, bg, 0.03, **opts)


def band(vis, y0, rows):
    return VisibilityBuffer(*(a[..., y0:y0 + rows, :].contiguous() for a in vis))


def random_bary(vis, seed=5):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return torch.rand((3,) + tuple(vis.depth.shape), generator=g).to(vis.depth.device)


def pixel_list(vis, k=2048, seed=7):
    g = torch.Generator(device="cpu").manual_seed(seed)
    h, w = vis.depth.shape
    xk = torch.randint(0, w, (k,), generator=g)
    yk = torch.randint(0, h, (k,), generator=g)
    good = torch.rand((k,), generator=g) > 0.2
    return PixelList(*(t.to(vis.depth.device) for t in (xk, yk, good)))


# per case: kernel 7's options, the shadow slots' size (None: no shadow)
OPTION_CASES = {
    "records": dict(shadow=512),
    "given_bary": dict(bary=True, shadow=512),
    "no_textures": dict(enable_textures=False, shadow=512),
    "no_normal_maps": dict(enable_normal_maps=False, shadow=512),
    "trilinear": dict(trilinear=True, shadow=512),
    "one_light": dict(n_lights=1, shadow=512),
    "two_lights": dict(n_lights=2, shadow=512),
    "atlas_4096": dict(shadow=4096),
    "no_shadow": dict(shadow=None),
}
# per case: (step_x, step_y, checker) or "list", and the band's first row (0: the whole buffer)
SAMPLE_CASES = {
    "full": ((1, 1, False), 0),
    "checkerboard": ((2, 1, True), 0),
    "checkerboard_band": ((2, 1, True), 37),
    "quarter": ((2, 2, False), 0),
    "quarter_band": ((2, 2, False), 38),
    "fix_list": ("list", 0),
}


@pytest.mark.gpu
@pytest.mark.parametrize("samples_case", sorted(SAMPLE_CASES))
@pytest.mark.parametrize("option_case", sorted(OPTION_CASES))
def test_shade_kernel_matches_plain(option_case, samples_case, cuda_device):
    opts = dict(OPTION_CASES[option_case])
    size, with_bary = opts.pop("shadow"), opts.pop("bary", False)
    scene, out, cam = frame_inputs(cuda_device, size or 512)
    lattice, y0 = SAMPLE_CASES[samples_case]
    vis = out["vis"] if y0 == 0 else band(out["vis"], y0, 64)
    frame = make_frame(scene, out, cam, vis, y0, **opts)
    if size is None:
        frame = frame._replace(shadow=None)
    samples = pixel_list(vis) if lattice == "list" else Lattice(*lattice)
    bary = random_bary(vis) if with_bary else None
    before = SHADE.launches
    got = shade_samples_kernel(frame, vis, samples, bary)
    want = shade_samples_plain_at(frame, vis, samples, bary)
    torch.cuda.synchronize()
    assert SHADE.launches == before + 1
    assert got.shape == want.shape
    covered = (want != frame.bg.reshape(3, *([1] * (want.dim() - 1)))).any(dim=0).float().mean()
    assert 0.2 < covered.item() and (y0 > 0 or covered.item() < 1.0)  # a band misses the sky
    assert torch.equal(got, want), (got - want).abs().max().item()
    if frame.shadow is not None:  # the shadows darken something
        assert not torch.equal(got, shade_samples_kernel(frame._replace(shadow=None), vis,
                                                         samples, bary))


@pytest.mark.gpu
@pytest.mark.parametrize("samples_case", ["full", "checkerboard"])
def test_shade_kernel_with_traced_planes(samples_case, cuda_device):
    scene, out, cam = frame_inputs(cuda_device, 512)
    vis = out["vis"]
    lattice = Lattice(*SAMPLE_CASES[samples_case][0])
    frame = make_frame(scene, out, cam, vis, traced_casts=((1, True), (0, False)))
    gh, gw = H // lattice.step_y, W // lattice.step_x
    g = torch.Generator(device="cpu").manual_seed(11)
    planes = [(torch.rand((gh, gw), generator=g) > 0.5).float().to(cuda_device) for _ in range(2)]
    got = shade_samples_kernel(frame, vis, lattice, planes=planes)
    want = shade_samples_plain_at(frame, vis, lattice, planes_fn=lambda *_: planes)
    without = shade_samples_kernel(frame, vis, lattice)
    assert torch.equal(got, want), (got - want).abs().max().item()
    assert not torch.equal(got, without)  # the planes darken something


def _faces(frame, vis, li):
    """Per covered pixel of the full frame, the cube face its receiver
    falls in for light ``li``, as shadow.shadow_occlusion picks it."""
    px = torch.arange(W, dtype=torch.float32, device=vis.depth.device)[None].expand(H, W) + 0.5
    py = torch.arange(H, dtype=torch.float32, device=vis.depth.device)[:, None].expand(H, W) + 0.5
    covered, world, _, _, _ = _sample_geometry(frame, vis.depth, vis.tri_id, px, py)
    d = world - frame.lights.position[li][:, None, None]
    a = d.abs()
    face = torch.where((a[0] >= a[1]) & (a[0] >= a[2]), torch.where(d[0] >= 0, 0, 1),
                       torch.where(a[1] >= a[2], torch.where(d[1] >= 0, 2, 3),
                                   torch.where(d[2] >= 0, 4, 5)))
    return torch.where(covered, face, -1)


EDGE_CASES = ("lsum_zero", "layer_minus_one", "outside_slot", "dead_light", "cube_face_edges")


@pytest.mark.gpu
@pytest.mark.parametrize("case", EDGE_CASES)
def test_shade_kernel_edge_cases(case, cuda_device):
    scene, out, cam = frame_inputs(cuda_device, 512,
                                   (4.0, 1.0, 6.0) if case == "cube_face_edges" else None)
    vis = out["vis"]
    frame = make_frame(scene, out, cam, vis)
    rec = frame.shade_rec.clone()
    ids = torch.arange(rec.shape[0], device=cuda_device)
    if case == "lsum_zero":  # every third triangle's edge functions sum to 0 everywhere
        rec[:, SR_EDGE:SR_EDGE + 9] = torch.where((ids % 3 == 0)[:, None], 0.0,
                                                  rec[:, SR_EDGE:SR_EDGE + 9])
        frame = frame._replace(shade_rec=rec)
    elif case == "layer_minus_one":  # no base colour or normal map texture on half the triangles
        for c in (SR_BC_LAYER, SR_NM_LAYER):
            rec[:, c] = torch.where(ids % 2 == 0, -1.0, rec[:, c])
        frame = frame._replace(shade_rec=rec)
    elif case == "outside_slot":  # the light's box a third as wide: most receivers fall outside
        mats = frame.shadow.light_mats.clone()
        mats[:, :, 0:2, :] *= 3.0
        frame = frame._replace(shadow=frame.shadow._replace(light_mats=mats))
    elif case == "dead_light":
        alive = frame.lights.alive.clone()
        alive[1] = False
        frame = frame._replace(lights=frame.lights._replace(alive=alive))
    else:  # the point light low over the floor: receivers on every side of it
        faces = _faces(frame, vis, 1)
        edges = ((faces[:, 1:] != faces[:, :-1]) & (faces[:, 1:] >= 0) & (faces[:, :-1] >= 0))
        assert len(set(faces[faces >= 0].tolist())) >= 3 and edges.sum() > 20
    for samples in (Lattice(), Lattice(2, 1, True), pixel_list(vis)):
        got = shade_samples_kernel(frame, vis, samples)
        want = shade_samples_plain_at(frame, vis, samples)
        assert torch.equal(got, want), (case, samples, (got - want).abs().max().item())
    if case != "cube_face_edges":  # the change shows
        assert not torch.equal(shade_samples_kernel(frame, vis, Lattice()), shade_samples_kernel(
            make_frame(scene, out, cam, vis), vis, Lattice()))


@pytest.mark.gpu
def test_shade_kernel_in_a_graph(cuda_device):
    scene, out, cam = frame_inputs(cuda_device, 512)
    vis = VisibilityBuffer(*(a.clone() for a in out["vis"]))
    frame = make_frame(scene, out, cam, vis)
    frame = frame._replace(shade_rec=frame.shade_rec.clone(), camera_pos=cam.position.clone(),
                           viewproj_inv=frame.viewproj_inv.clone())
    samples = pixel_list(vis)
    shade_samples_kernel(frame, vis, samples)  # loaded before the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        lattice_out = shade_samples_kernel(frame, vis, Lattice(2, 1, True))
        list_out = shade_samples_kernel(frame, vis, samples)
    # another view of the scene into the captured buffers, then replay
    other, cam2, _ = render(scene, PipelineConfig(width=W, height=H, tri_capacity=4096,
                                                  shadow_slots=2, shadow_size=512,
                                                  shadow_cache=False), cuda_device,
                            pos=[-5.0, 10.0, 12.0])
    for a, b in zip(vis, other["vis"]):
        a.copy_(b)
    frame.shade_rec.copy_(other["shade_rec"])
    frame.camera_pos.copy_(cam2.position)
    frame.viewproj_inv.copy_(other["prepared"].vp_inv)
    graph.replay()
    torch.cuda.synchronize()
    for got, samples_ in ((lattice_out, Lattice(2, 1, True)), (list_out, samples)):
        want = shade_samples_plain_at(frame, vis, samples_)
        assert torch.equal(got, want), (got - want).abs().max().item()


# the benchmark configurations' scene and pipeline options (benchmark/configs/),
# written out: (scene limits, envelope lights, pipeline options)
BENCH_OPTIONS = {
    "sponza10k_1080p": (None, 0, dict(shadow_slots=4, shadow_size=512)),
    "envelope16x4096": (dict(max_instances=16384, max_vertices=65536, max_triangles=65536,
                             max_materials=64, max_lights=16), 16,
                        dict(shade_light_slots=2, shadow_slots=16, shadow_size=4096)),
}


def bench_frame_inputs(config: str, device, rate: str):
    """The benchmark configuration ``config``'s scene at 64 instances and its
    pipeline at 256x128 and ``rate``: one eager frame's outputs."""
    limits, envelope, opts = BENCH_OPTIONS[config]
    scene = sponza_like_scene(64, seed=3, limits=limits and SceneLimits(**limits), device=device)
    if envelope:
        scene = scene._replace(lights=shadow_envelope_lights(envelope, device=device))
    cfg = PipelineConfig(width=W, height=H, tri_capacity=4096, shading="pbr",
                         enable_normal_maps=True, aa="edge", trilinear=False,
                         shade_rate="full" if rate.startswith("full") else rate.split("_")[0],
                         shade_fix=True, shadow_cache=False, shadow_update_budget=1,
                         shadow_progressive=1, shadow_tri_capacity=4096, **opts)
    return render(scene, cfg, device)


def shade_frame(out, cam, r, rate):
    """``shade_pbr`` on the frame's buffers, as the pipeline calls it at
    ``rate``."""
    cfg = r.cfg
    vis, y0 = out["vis"], 0
    if rate == "checkerboard_fix_band":  # a split frame's row band, from an odd row
        vis, y0 = band(vis, 37, 64), 37
    if rate == "full_given_bary":
        vis = vis._replace(bary=random_bary(vis))
    return shade_pbr(vis, out["shade_rec"], r.scene, cam.position, out["prepared"].vp_inv,
                     y0=y0, full_height=H, background=cfg.background,
                     enable_textures=cfg.enable_textures,
                     enable_normal_maps=cfg.enable_normal_maps, trilinear=cfg.trilinear,
                     light_slots=cfg.shade_light_slots, aa=(cfg.aa == "edge"),
                     shadow=out["shadow"], checkerboard=rate.startswith("checkerboard"),
                     quarter=rate.startswith("quarter"),
                     bary_from_records=rate != "full_given_bary")


RATES = ("checkerboard_fix", "checkerboard_fix_band", "quarter_fix", "full", "full_given_bary")


@pytest.mark.gpu
@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("config", sorted(BENCH_OPTIONS))
def test_shade_pbr_frame_matches_plain_on_the_card(config, rate, cuda_device, monkeypatch):
    """A whole frame through kernel 7 against the same frame with the plain
    version shading each of its grids on the card."""
    out, cam, r = bench_frame_inputs(config, cuda_device, rate)
    before = SHADE.launches
    got = shade_frame(out, cam, r, rate)
    torch.cuda.synchronize()
    fix = rate.endswith("_fix") or rate.endswith("_band")
    assert SHADE.launches == before + (2 if fix else 1)

    def plain(frame, vis, samples, bary=None, planes=None):
        return shade_samples_plain_at(frame, vis, samples, bary,
                                      None if planes is None else (lambda *_: planes))

    monkeypatch.setattr(pbr, "shade_samples_kernel", plain)
    want = shade_frame(out, cam, r, rate)
    assert SHADE.launches == before + (2 if fix else 1)
    assert torch.equal(got, want), (got - want).abs().max().item()


@pytest.mark.parametrize("samples_case", sorted(set(SAMPLE_CASES) - {"full"}))
def test_plain_samples_shade_their_pixels_as_the_full_frame(samples_case):
    """On the CPU, the plain version at every grid's samples (the lattices,
    from an odd row too, a fix's list) lands on the pixels the rebuilds and
    fixes put them at and shades each as the full frame does."""
    scene, out, cam = frame_inputs(torch.device("cpu"), 128)
    lattice, y0 = SAMPLE_CASES[samples_case]
    vis = out["vis"] if y0 == 0 else band(out["vis"], y0, 64)
    frame = make_frame(scene, out, cam, vis, y0)
    full = shade_samples_plain_at(frame, vis, Lattice())
    if lattice == "list":
        samples = pixel_list(vis)
        want = torch.where(samples.good, full[:, samples.yk, samples.xk], frame.bg[:, :, 0])
    elif lattice[2]:  # the checkerboard's packing: x = 2j + ((y + y0) & 1)
        samples = Lattice(*lattice)
        rowpar = ((torch.arange(vis.depth.shape[0]) + y0) & 1)[:, None]
        want = torch.where(rowpar == 0, full[:, :, 0::2], full[:, :, 1::2])
    else:  # the quarter rate's (even x, even y)
        samples = Lattice(*lattice)
        want = full[:, 0::2, 0::2]
    got = shade_samples_plain_at(frame, vis, samples)
    assert (got != frame.bg.reshape(3, *([1] * (got.dim() - 1)))).any(dim=0).float().mean() > 0.2
    assert torch.equal(got, want), (got - want).abs().max().item()


@pytest.mark.parametrize("samples_case", ["checkerboard_band", "quarter", "fix_list"])
def test_sample_rays_match_the_full_geometry(samples_case):
    """What the traced shadows' planes are computed from on the card (the
    18-column gather) equals what the plain version hands ``planes_fn``
    (the 45-column gather), bit for bit."""
    scene, out, cam = frame_inputs(torch.device("cpu"), 128)
    lattice, y0 = SAMPLE_CASES[samples_case]
    vis = out["vis"] if y0 == 0 else band(out["vis"], y0, 64)
    frame = make_frame(scene, out, cam, vis, y0, traced_casts=())
    samples = pixel_list(vis) if lattice == "list" else Lattice(*lattice)
    for bary in (None, random_bary(vis)):
        got = pbr.sample_rays(frame, vis, samples, bary)
        seen = []
        shade_samples_plain_at(frame, vis, samples, bary, lambda *a: seen.append(a) or [])
        (want,) = seen
        assert all(torch.equal(g, w) for g, w in zip(got, want, strict=True))


def test_cpu_shade_pbr_builds_no_kernel(monkeypatch):
    def refuse(*_):
        raise AssertionError("csrc/shade.cu built or loaded for a CPU frame")

    monkeypatch.setattr(pbr.LIBRARY, "start", refuse)
    monkeypatch.setattr(pbr.LIBRARY, "load", refuse)
    scene, out, cam = frame_inputs(torch.device("cpu"), 128)
    frame = make_frame(scene, out, cam, out["vis"])
    before = SHADE.launches
    img = shade_pbr(out["vis"], out["shade_rec"], scene, cam.position, out["prepared"].vp_inv,
                    shadow=frame.shadow, checkerboard=True)
    assert img.shape == (H, W, 3) and SHADE.launches == before
    with pytest.raises(ValueError, match="CUDA"):  # the kernel's wrapper takes no CPU tensor
        shade_samples_kernel(frame, out["vis"], Lattice())
