"""The output check's control: the reference in bfloat16 put in the
program's place, compared with the reference in float32 by the check's own
numbers, at a cell's own sizes and on the frames a run compares.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3 --frames 700

For each seed it builds the cell's scene, follows the atlas schedule from
the renderer's first frame to window frame ``--frames - 1`` (a window's
length of frames), and prints one JSON line per seed with the control's
numbers beside the cell's limits; the check must fail it. No frame of the
port is rendered: the port only builds the scene.
"""

import argparse
import json
import os
import sys
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


def control_numbers(cell: str, seed: int, frames: int, device, override=None,
                    bench_dir: str = BENCH_DIR) -> dict:
    """{frame: the control's numbers} for one seed."""
    from benchmark.harness import check
    from benchmark.harness.cell import inputs, reference_scenes

    _, cfg, scene, traffic, n_setup = inputs(cell, seed, device, override, bench_dir)
    pc = cfg["pipeline"]
    scene_at = reference_scenes(scene, traffic, device)
    reference = check.reference_module(cfg)
    fr = reference.Frames(scene_at, traffic.pose, pc, device, traffic.scene_key)
    last = frames - 1
    ks = set(traffic.compared(frames)) | {last}
    exact, atlas = reference.outputs(fr, -n_setup, last, ks, "float32")
    low, low_atlas = reference.outputs(fr, -n_setup, last, ks, "bfloat16")
    out = {k: check.frame_numbers(low[k], exact[k]) for k in sorted(ks)}
    out[last]["draw_mismatch"] = float(check.draw_mismatch(low[last]["draw_list"],
                                                           exact[last]["draw_list"]))
    out[last]["atlas_err"] = float((low_atlas - atlas).abs().max())
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--frames", type=int, required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from benchmark.harness import check, spec

    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    limits = spec.workload(args.workload)["limits"]
    for seed in args.seeds:
        t0 = time.perf_counter()
        per_frame = control_numbers(args.workload, seed, args.frames, torch.device("cuda"))
        worst = check.worst(per_frame)
        ok, table = check.verdict(worst, limits)
        print(json.dumps({"workload": args.workload, "seed": seed, "control_passes": ok,
                          "seconds": round(time.perf_counter() - t0, 1), "numbers": table}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
