"""The benchmark of the PyTorch and CUDA port (``renderer_tpu_torch``): one
run of one cell on one NVIDIA card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The cell is ``benchmark/workloads/<cell>.json``
(its configuration under ``benchmark/configs/``, its traffic mix under
``benchmark/traffic/``, its metrics' readers under ``benchmark/metrics/``). The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``, each
number of the output check beside its limit; the check's numbers are also
the last lines of standard error. Without a CUDA card the run exits with
code 2 and prints no result. The port's kernels build into
``renderer_tpu_torch/_build/`` inside the checkout.
"""

import time

T_START = time.perf_counter()  # the process's start, as near as the script can read it

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


def cache_env() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    build = os.path.join(ROOT, "renderer_tpu_torch", "_build")
    os.environ["RENDERER_TPU_COMPILE_CACHE"] = build
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ.setdefault("USE_FLAX", "0")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_env()
    sys.path.insert(0, ROOT)
    import torch

    with open(os.path.join(BENCH_DIR, "workloads", f"{args.workload}.json")) as f:
        chips = int(json.load(f).get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: needs {chips} CUDA card(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, device_count {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    from benchmark.harness import cell

    line, table = cell.run(args.workload, args.seed, args.seconds, bool(args.trace), T_START)
    for name, row in table.items():
        print(f"check {name}: {row['value']!r} (limit {row['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
