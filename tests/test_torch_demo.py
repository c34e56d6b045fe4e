"""The demo CLI (renderer_tpu_torch/demo.py) on the CPU: every scene (the
colonnade through the committed GLB, and a glb:<path>) and the HUD,
reference-view, plan-dump and --watch flags write a PNG of the asked
size; --spmd 2 splits the frame over two CPU shards with --device cpu,
and exits naming the virtual mesh on a host with fewer cards."""

import os

import numpy as np
import pytest

from renderer_tpu_torch import demo
from renderer_tpu_torch.utils.image import read_png

SIZE = 64


def run(tmp_path, *args):
    out = str(tmp_path / "frame.png")
    demo.main(["--size", str(SIZE), "--out", out, "--device", "cpu", *args])
    img = read_png(out)
    assert img.shape == (SIZE, SIZE, 3)
    return img


@pytest.mark.parametrize("scene", demo.SCENES)
def test_demo_renders_each_scene(tmp_path, scene):
    # the city at a small capacity: the plain raster walks every block on the CPU
    extra = ("--tri-capacity", "8192") if scene == "city" else ()
    img = run(tmp_path, "--scene", scene, *extra)
    assert img.std() > 2.0  # not a flat background


@pytest.mark.parametrize("flags", [("--hud",), ("--reference-image",), ("--dump-graphs",),
                                   ("--shade-rate", "quarter", "--ssaa", "2", "--frames", "2")])
def test_demo_flags(tmp_path, capsys, flags):
    img = run(tmp_path, "--scene", "textured", *flags)
    printed = capsys.readouterr().out
    if "--hud" in flags:
        assert "active passes: pose -> prepare -> cull -> raster -> shade -> present" in printed
        plain = run(tmp_path, "--scene", "textured")
        assert np.abs(img.astype(int) - plain)[4:30, 4:60].max() > 60  # the panel is drawn
    if "--dump-graphs" in flags:
        dot = open(os.path.join(tmp_path, "forward-plan.dot")).read()
        assert dot.startswith("digraph") and '"raster" -> "shade"' in dot
    if "--frames" in flags:
        assert "steady-state" in printed


@pytest.mark.parametrize("args", [("--spmd", "2")])
def test_demo_refuses_what_is_not_ported(tmp_path, args, monkeypatch):
    """A split over more cards than the host has exits naming the virtual
    mesh that puts the shards on one card, and renders nothing."""
    monkeypatch.setattr(demo.torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match=r"only 1 CUDA devices.*make_mesh\(\[dev\] \* 2\)"):
        demo.main(["--size", str(SIZE), "--out", str(tmp_path / "x.png"), *args])
    assert not (tmp_path / "x.png").exists()


def test_demo_split_frame_on_cpu(tmp_path, capsys):
    """--spmd 2 --device cpu renders the frame over two CPU shards: the
    PNG of the single-shard frame, within one level."""
    split = run(tmp_path, "--scene", "textured", "--spmd", "2")
    one = run(tmp_path, "--scene", "textured")
    assert split.std() > 2.0
    assert np.abs(split.astype(int) - one).max() <= 1


def test_demo_glb_scene_is_the_colonnade(tmp_path):
    """glb:<path> of the committed asset renders the --scene colonnade frame
    but for the camera's orbit (radius 4 and height 1.6 for a glb:)."""
    img = run(tmp_path, "--scene", f"glb:{demo.ASSET}")
    assert img.std() > 2.0
    scene = demo.build_scene(f"glb:{demo.ASSET}", "cpu")
    twin = demo.build_scene("colonnade", "cpu")
    assert int(scene.instances.count) == int(twin.instances.count) == 242
    assert all(np.array_equal(a.numpy(), b.numpy()) for a, b in zip(scene.meshes, twin.meshes)
               if a is not None)


def test_demo_watch_polls_between_frames(tmp_path, capsys, monkeypatch):
    """--watch hot-reloads between frames: a reload shows in the output and
    the frames after it render."""
    from renderer_tpu_torch.runtime import reload

    polls = []

    def poll(self):
        polls.append(self.stats["reloads"])
        if len(polls) == 2:  # as if a watched module changed before frame 1
            self.stats["reloads"] += 1
            return True
        return False

    monkeypatch.setattr(reload.KernelReloader, "poll", poll)
    img = run(tmp_path, "--scene", "box", "--watch", "--frames", "3")
    printed = capsys.readouterr().out
    assert polls == [0, 0, 1] and "[watch] kernels reloaded at frame 1" in printed
    assert "steady-state" in printed and img.std() > 2.0
