"""The committed goldens against the JAX package's and the port's frame.

``bench.py`` reports ``psnr_vs_golden_db`` against
``assets/golden/shadowed_pose{0,1,2}.png``. This script tells a fault of
the port apart from a golden that no longer matches the reference: it
renders the bench scene (``sponza_like_scene(10000)``) at one gate pose
through the JAX package (plain XLA raster, post-cull capacity large enough
that nothing is truncated) and through the port, both on the CPU at a
reduced 512x288 with the bench camera's 1920/1088 aspect, exact shading,
no AA, bilinear. It prints the PSNR of port against JAX, of each against
the golden resized to 512x288, and the displacement of 32x32 blocks of the
golden in each frame (the best-correlated shift, rows by columns).

Run on the CPU (about 7 minutes, 1-2 GB):
    python tests/torch_golden_check.py [pose index 0-2, default 2]
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

W, H = 512, 288
BLOCK, REACH = 32, 5
ROWS, COLS = (100, 170, 230), (20, 140, 260, 380, 460)


def luminance(img):
    return (0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]).astype(np.float32)


def displacement(ref, img, y, x):
    """The shift (dy, dx) that best correlates the block of ``ref`` at
    (y, x) with ``img``."""
    a = ref[y:y + BLOCK, x:x + BLOCK]
    a = a - a.mean()
    best, shift = -np.inf, None
    for dy in range(-REACH, REACH + 1):
        for dx in range(-REACH, REACH + 1):
            yy, xx = y + dy, x + dx
            if yy < 0 or xx < 0 or yy + BLOCK > ref.shape[0] or xx + BLOCK > ref.shape[1]:
                continue
            b = img[yy:yy + BLOCK, xx:xx + BLOCK]
            b = b - b.mean()
            v = (a * b).sum() / (np.sqrt((a * a).sum() * (b * b).sum()) + 1e-6)
            if v > best:
                best, shift = v, (dy, dx)
    return shift


def main() -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from PIL import Image

    import bench
    from renderer_tpu.models import sponza_like_scene as jax_scene
    from renderer_tpu.passes.pipeline import PipelineConfig as JaxConfig
    from renderer_tpu.runtime import Renderer as JaxRenderer
    from renderer_tpu_torch.mathx import orbit_camera
    from renderer_tpu_torch.models import sponza_like_scene
    from renderer_tpu_torch.passes.pipeline import PipelineConfig
    from renderer_tpu_torch.runtime import Renderer
    from renderer_tpu_torch.utils.image import psnr, read_png

    pose = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    angle = bench.GATE_ANGLES[pose]
    opts = dict(width=W, height=H, enable_normal_maps=True, aa="none", trilinear=False)
    jr = JaxRenderer(jax_scene(bench.N_INSTANCES),
                     JaxConfig(shading="pbr", tri_capacity=1 << 18, **opts), outputs=("image",))
    want = np.clip(np.asarray(jr.render(bench.make_camera(angle))["image"]), 0.0, 1.0)
    r = Renderer(sponza_like_scene(bench.N_INSTANCES, device="cpu"),
                 PipelineConfig(tri_capacity=bench.TRI_CAPACITY, **opts))
    got = np.clip(r.render(orbit_camera(angle, bench.WIDTH / bench.HEIGHT, "cpu"))["image"]
                  .numpy(), 0.0, 1.0)
    golden = read_png(os.path.join(ROOT, bench.GOLDEN_DIR, f"shadowed_pose{pose}.png"))
    golden = np.asarray(Image.fromarray(golden[..., :3]).resize((W, H), Image.BILINEAR),
                        np.float32) / 255.0

    print(f"pose {pose} (angle {angle}), {W}x{H}: PSNR port vs JAX {psnr(got, want):.2f} dB; "
          f"vs the golden resized: JAX {psnr(want, golden):.2f} dB, port {psnr(got, golden):.2f} dB")
    g = luminance(golden)
    for name, img in (("JAX", want), ("port", got)):
        lum = luminance(img)
        print(f"displacement of the golden's {BLOCK}x{BLOCK} blocks in the {name} frame, "
              "(dy, dx) px by block row and column: "
              + "; ".join(f"y {y}: {[displacement(g, lum, y, x) for x in COLS]}" for y in ROWS))
    return 0


if __name__ == "__main__":
    sys.exit(main())
