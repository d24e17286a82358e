"""The benchmark of rtweekend_tpu_torch on the card: one run of one cell.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

Prints, as the last line of standard output, one JSON object: correct,
attempted, failed, metrics (the cell's end-to-end metrics, or with
--trace 1 its per-layer metrics), device, with --trace 1 a breakdown of
the traced window, and last the numbers compared beside their limits,
which also end standard error. Exits non-zero without a result when the
card is missing or has fewer devices than the cell asks for, or when the
process has loaded JAX or the JAX package.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from benchmark import harness

    # few host threads: the card's host is shared, and only the schedule's
    # CPU probe runs torch on the host
    torch.set_num_threads(4)

    _, cell, _, _, _ = harness.cell_parts(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"error: the cell needs {cell['chips']} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, count: "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              t_start=T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"error: the run loaded {found}: the benchmark runs no JAX", file=sys.stderr)
        return 3
    for k, v in result["compared"].items():
        print(f"compared {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
