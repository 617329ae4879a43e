"""Run one cell of the port's benchmark once, on the CUDA card.

    python3 bench_torch/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The last line of standard output is the result: one JSON object with
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device`` and, last,
``checks`` (each number compared with the reference, beside its limit).
Standard error carries the set-up split, the window's counts and, as its
last lines, the same checks.  Without a CUDA card the run fails and prints
no result.  ``--control`` serves with the configuration's lower-precision
control path (for the comparison's own test; no benchmark run uses it).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "bench_torch", ".cache")
# the program's and the libraries' build caches, at fixed paths inside the
# checkout, so that only a checkout's first run builds
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args()

    import torch

    from bench_torch import harness

    chips = harness.Cell.find(ROOT, args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA card(s); the benchmark runs only "
              f"on the card", file=sys.stderr)
        return 2
    torch.cuda.init()
    torch.zeros(1, device="cuda")
    t_cuda = time.perf_counter()

    out = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                           bool(args.trace), "cuda", T_START, t_cuda,
                           control=args.control)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
