"""Demo CLI: render a test scene to a PNG (``renderer_tpu.demo``).

    python -m renderer_tpu_torch.demo --scene textured --size 512 --out frame.png
    python -m renderer_tpu_torch.demo --scene box --size 64 --out box.png --device cpu
    python -m renderer_tpu_torch.demo --scene glb:assets/colonnade.glb --frames 30 --watch

The frame renders on the CUDA card (kernel 1, ``csrc/raster.cu``, is the
raster); ``--device cpu`` runs the plain PyTorch versions on the CPU.
The raster choice maps onto the JAX demo's the other way round: the JAX
demo takes its plain XLA configuration unless given ``--pallas`` (the
tile kernel); this demo takes kernel 1 unless given ``--scan-raster``,
which selects the plain configuration (``PipelineConfig(tile_raster=
False)``: the scan rasterizer, raster barycentrics, and for ``--rt`` exact
brute-force rays).
Scenes: box, spheres, mixed, textured, skinned, city, colonnade (the
committed ``assets/colonnade.glb``) and glb:<path> (a .glb or .gltf with
the colonnade's lights). ``--watch`` hot-reloads the ops and passes
modules and the kernel sources between frames (``runtime.reload``).
``--spmd N`` splits the frame over N shards (``parallel.sharding``): the
first N CUDA cards, or with ``--device cpu`` N shards on the CPU (the
JAX demo's forced host-device count). On one card the split runs over a
virtual mesh, ``make_mesh([dev] * N)``, from the library.
"""

from __future__ import annotations

import argparse
import contextlib
import math
import os
import time

import numpy as np
import torch

SCENES = ("box", "spheres", "mixed", "textured", "skinned", "city", "colonnade")
ASSET = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets",
                     "colonnade.glb")


@contextlib.contextmanager
def no_blocking_sync(on: bool):
    """With ``on``, CUDA work inside raises on any blocking host-device
    synchronization (``torch.cuda.set_sync_debug_mode("error")``)."""
    if not on:
        yield
        return
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


def build_scene(name: str, device):
    from renderer_tpu_torch.mathx import quat_from_axis_angle
    from renderer_tpu_torch.models import city_scene, skinned_scene
    from renderer_tpu_torch.models.scenes import _colonnade_lights
    from renderer_tpu_torch.scene import SceneBuilder, SceneLimits, primitives
    from renderer_tpu_torch.scene.gltf import load_gltf

    if name == "colonnade" or name.startswith("glb:"):
        # through the glTF parser (the colonnade's procedural twin is
        # models.colonnade_scene); a GLB carries no lights
        b = load_gltf(ASSET if name == "colonnade" else name[4:], SceneBuilder(SceneLimits()))
        _colonnade_lights(b)
        return b.build(device=device)
    if name == "skinned":
        return skinned_scene(device=device)
    if name == "city":
        return city_scene(device=device)
    if name not in SCENES:
        raise SystemExit(f"unknown scene {name!r} (try: {', '.join(SCENES)}, glb:<path>)")
    b = SceneBuilder(SceneLimits())
    if name == "box":
        box = b.add_mesh(primitives.box())
        red = b.add_material(base_color=(0.8, 0.25, 0.2, 1.0))
        rot = quat_from_axis_angle((0.0, 1.0, 0.0), 0.6, device="cpu").numpy()
        b.add_instance(box, red, rotation=rot)
    elif name == "spheres":
        sph = b.add_mesh(primitives.uv_sphere(rings=24, sectors=48))
        plane = b.add_mesh(primitives.plane(size=20.0))
        b.add_instance(plane, b.add_material(base_color=(0.6, 0.6, 0.62, 1.0)),
                       translation=(0, -0.6, 0))
        for i in range(5):
            for j in range(5):
                m = b.add_material(base_color=(0.2 + 0.2 * i, 0.25, 0.95 - 0.2 * j, 1.0),
                                   roughness=0.1 + 0.2 * i, metallic=0.25 * j)
                b.add_instance(sph, m, translation=(i - 2.0, 0.0, j - 2.0), scale=0.45)
    elif name == "mixed":
        box = b.add_mesh(primitives.box())
        sph = b.add_mesh(primitives.uv_sphere(rings=16, sectors=24))
        tor = b.add_mesh(primitives.torus())
        plane = b.add_mesh(primitives.plane(size=12.0))
        b.add_instance(plane, b.add_material(base_color=(0.55, 0.55, 0.6, 1)),
                       translation=(0, -0.8, 0))
        b.add_instance(box, b.add_material(base_color=(0.8, 0.3, 0.2, 1)), translation=(-1.4, 0, 0))
        b.add_instance(sph, b.add_material(base_color=(0.2, 0.5, 0.9, 1)), translation=(0, 0, 0),
                       scale=0.8)
        b.add_instance(tor, b.add_material(base_color=(0.3, 0.8, 0.3, 1)),
                       translation=(1.5, -0.2, 0), scale=0.7)
    else:  # textured
        plane = b.add_mesh(primitives.plane(size=16.0))
        sph = b.add_mesh(primitives.uv_sphere(rings=24, sectors=48))
        box = b.add_mesh(primitives.box())
        checker = b.add_texture(primitives.checkerboard_texture(256, squares=16))
        checker2 = b.add_texture(primitives.checkerboard_texture(
            256, squares=6, c0=(230, 120, 60), c1=(250, 235, 220)))
        floor = b.add_material(base_color=(1, 1, 1, 1), roughness=0.6, base_color_tex=checker)
        shiny = b.add_material(base_color=(1, 1, 1, 1), roughness=0.25, metallic=0.1,
                               base_color_tex=checker2)
        metal = b.add_material(base_color=(0.95, 0.64, 0.54, 1), roughness=0.3, metallic=1.0)
        b.add_instance(plane, floor, translation=(0, -0.6, 0))
        b.add_instance(sph, shiny, translation=(-0.9, 0, 0), scale=1.1)
        b.add_instance(sph, metal, translation=(0.9, 0, 0), scale=1.1)
        b.add_instance(box, shiny, translation=(0, -0.1, -1.6))
    b.add_light(position=(3.0, 5.0, 4.0), intensity=30.0)
    b.add_light(position=(-0.5, -1.0, -0.3), directional=True, intensity=0.35, shadow_slot=0)
    return b.build(device=device)


def make_camera(scene: str, angle: float, device):
    """The orbit of the small scenes (wider and higher for the colonnade),
    or the city's street walk."""
    from renderer_tpu_torch.mathx import Camera, quat_from_axis_angle, quat_mul

    if scene == "city":
        rot = quat_from_axis_angle((0.0, 1.0, 0.0), 0.15 * math.sin(angle), device="cpu")
        return Camera.create((0.0, 2.0, 70.0 - 20.0 * angle), rot.numpy(), fov_y=0.9, near=0.1,
                             far=400.0, device=device)
    r, h = (14.0, 3.0) if scene == "colonnade" else (4.0, 1.6)
    pos = (r * math.sin(angle), h, r * math.cos(angle))
    rot = quat_mul(quat_from_axis_angle((0.0, 1.0, 0.0), angle, device="cpu"),
                   quat_from_axis_angle((1.0, 0.0, 0.0), -0.35, device="cpu"))
    return Camera.create(pos, rot.numpy(), fov_y=0.9, near=0.1, far=100.0, device=device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--scene", default="box")
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--out", default="render.png")
    ap.add_argument("--orbit", type=float, default=0.5, help="camera orbit angle (rad)")
    ap.add_argument("--frames", type=int, default=1, help="render N orbit frames (timing)")
    ap.add_argument("--tri-capacity", type=int, default=None,
                    help="triangles kept after the cull (default 16384; 2^18 for the city)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' for the plain versions)")
    ap.add_argument("--debug-aabbs", action="store_true", help="draw the instances' AABBs")
    ap.add_argument("--freeze-culling", action="store_true")
    ap.add_argument("--shadows", action="store_true", help="shadow-mapped lights")
    ap.add_argument("--occlusion", action="store_true", help="two-pass occlusion culling")
    ap.add_argument("--rt", action="store_true", help="ray-traced shadows")
    ap.add_argument("--scan-raster", action="store_true",
                    help="the plain configuration (the JAX demo's default, without --pallas): "
                         "the scan rasterizer instead of kernel 1, brute-force rays for --rt")
    ap.add_argument("--reference-image", action="store_true",
                    help="tint where the frame differs from the independent scan rasterizer's")
    ap.add_argument("--ssaa", type=int, default=1, help="supersampling factor")
    ap.add_argument("--shade-rate", default="full", choices=("full", "checkerboard", "quarter"),
                    help="shade every pixel, the (x+y)-even half or the (even, even) quarter "
                         "and rebuild the rest from same-triangle neighbours")
    ap.add_argument("--no-shade-fix", action="store_true",
                    help="do not re-shade the worst rebuilt pixels exactly")
    ap.add_argument("--hud", action="store_true",
                    help="print the stats HUD and blend it into the frame")
    ap.add_argument("--dump-graphs", action="store_true",
                    help="write the active plan as .dot next to --out")
    ap.add_argument("--check-sync", action="store_true",
                    help="render every frame after the first under "
                         "torch.cuda.set_sync_debug_mode('error') (the card only)")
    ap.add_argument("--watch", action="store_true", help="hot-reload kernels between frames")
    ap.add_argument("--spmd", type=int, default=0, metavar="N",
                    help="split the frame over N cards (N CPU shards with --device cpu)")
    args = ap.parse_args(argv)

    from renderer_tpu_torch.graph.dot import dump
    from renderer_tpu_torch.ops.overlay import hud_overlay
    from renderer_tpu_torch.passes.pipeline import PipelineConfig
    from renderer_tpu_torch.runtime import KernelReloader, Renderer
    from renderer_tpu_torch.runtime.hud import format_hud
    from renderer_tpu_torch.utils.image import srgb_encode, write_png

    spmd_mesh = None
    if args.spmd > 1:
        from renderer_tpu_torch.parallel import make_mesh

        if args.device == "cpu":
            spmd_mesh = make_mesh(["cpu"] * args.spmd)
        elif torch.cuda.device_count() < args.spmd:
            raise SystemExit(f"--spmd {args.spmd}: only {torch.cuda.device_count()} CUDA devices "
                             f"visible (on one card: Renderer(..., spmd_mesh=make_mesh([dev] * "
                             f"{args.spmd})), from renderer_tpu_torch.parallel)")
        else:
            spmd_mesh = make_mesh([f"cuda:{i}" for i in range(args.spmd)])
    device = torch.empty(0, device=args.device or "cuda").device
    check = args.check_sync and device.type == "cuda"
    scene = build_scene(args.scene, device)
    renderer = Renderer(
        scene,
        PipelineConfig(width=args.size, height=args.size,
                       tri_capacity=args.tri_capacity or (1 << 18 if args.scene == "city"
                                                          else 16384),
                       skinning=args.scene == "skinned", ssaa=args.ssaa,
                       shade_rate=args.shade_rate, shade_fix=not args.no_shade_fix,
                       tile_raster=not args.scan_raster, spmd_devices=max(args.spmd, 1)),
        outputs=("image", "vis", "prepared") if args.hud else ("image", "vis"), device=device,
        spmd_mesh=spmd_mesh)
    renderer.set_config(debug_aabbs=args.debug_aabbs, freeze_culling=args.freeze_culling,
                        shadows=args.shadows, occlusion_culling=args.occlusion, rt=args.rt,
                        reference_image=args.reference_image)
    renderer.apply_config_now()
    if args.dump_graphs:
        path = dump(renderer.passes, vars(renderer.config),
                    os.path.dirname(os.path.abspath(args.out)))
        print(f"wrote {path}")

    t0 = time.time()
    out = renderer.render(make_camera(args.scene, args.orbit, device), time_s=0.0)
    img = out["image"].cpu()
    print(f"first frame (kernels built on first use): {time.time() - t0:.2f} s on {device}")
    reloader = KernelReloader(renderer) if args.watch else None
    if args.frames > 1:
        t0 = time.time()
        with no_blocking_sync(check):
            for k in range(args.frames):
                if reloader is not None and reloader.poll():
                    print(f"[watch] kernels reloaded at frame {k}")
                out = renderer.render(make_camera(args.scene, args.orbit + 0.02 * k, device),
                                      time_s=k / 60.0)
        img = out["image"].cpu()
        dt = (time.time() - t0) / args.frames
        print(f"steady-state: {dt * 1e3:.1f} ms/frame ({1.0 / dt:.1f} FPS)")
    covered = float((out["vis"].tri_id >= 0).float().mean())
    print(f"coverage: {covered:.1%}")
    if args.hud:
        text = format_hud(renderer, extra={"coverage": f"{covered:.1%}"},
                          prepared=out.get("prepared"))
        print(text)
        renderer.set_config(hud=True)
        renderer.apply_config_now()
        overlay = hud_overlay(text, args.size)
        renderer.render(make_camera(args.scene, args.orbit, device), overlay=overlay)
        with no_blocking_sync(check):  # the HUD frame, its plan and font already made
            out = renderer.render(make_camera(args.scene, args.orbit, device), overlay=overlay)
        img = out["image"].cpu()
    write_png(args.out, srgb_encode(img.numpy()))
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
