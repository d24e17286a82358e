"""The readings that the check's limits are set from, for one cell, in one
process on the card: sound runs of the program on many seeds, the control
(the reference traced one precision step down in the program's place),
and each planted fault (benchmark/faults.py), each at the cell's own
size and load with a short window.

    python3 benchmark/readings.py --workload NAME --seeds 1,2,3 \
        [--control-seeds 4,5,6] [--faults stale,half,alter] [--fault-seeds 7,8,9] \
        [--seconds 1]

Prints one JSON line a run: what ran, its seed, the numbers compared and
the end-to-end metrics. Not run by the benchmark's own runs.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--faults", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--device", default=None)
    args = p.parse_args(argv)

    from benchmark import faults, harness

    def ints(s):
        return [int(x) for x in s.split(",") if x]

    def one(kind, seed, **kw):
        t0 = time.perf_counter()
        detail = {}
        r = harness.run_cell(args.workload, seed, args.seconds, False, t_start=t0,
                             device=args.device, detail=detail, **kw)
        print(json.dumps({"kind": kind, "seed": seed, "correct": r["correct"],
                          "compared": {k: v["value"] for k, v in r["compared"].items()},
                          "metrics": {k: v["value"] for k, v in r["metrics"].items()},
                          "attempted": r["attempted"], "run_s": time.perf_counter() - t0,
                          "leaf_gaps": detail.get("leaf_gaps")}),
              flush=True)

    for s in ints(args.seeds):
        one("sound", s)
    for s in ints(args.control_seeds):
        one("control", s, control=True)
    for f in [x for x in args.faults.split(",") if x]:
        for s in ints(args.fault_seeds):
            with faults.planted(f):
                one(f, s)
    return 0


if __name__ == "__main__":
    sys.exit(main())
