"""Repeated runs of cells, each a fresh process as the benchmark's checks
run them, and the spread of each metric: the distance between the first
and third quartiles (statistics.quantiles, n=4) over the median.

    python3 benchmark/sets.py --workload NAME --seeds 1,2,3 [--sets 2] \
        [--trace-seeds 4,5,6] [--seconds 30] [--out FILE]

Runs the seeds once per set (the same seeds in every set), then one
traced run per trace seed; writes every result line to --out (JSON
lines) and prints each set's medians and spreads.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent


def spread(values):
    q1, med, q3 = statistics.quantiles(values, n=4)
    return med, (q3 - q1) / med


def run(workload, seed, seconds, trace, timeout):
    cmd = [sys.executable, str(HERE / "run.py"), "--workload", workload, "--seed", str(seed),
           "--seconds", str(seconds), "--trace", str(trace)]
    t0 = time.perf_counter()
    p = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    line = p.stdout.strip().splitlines()[-1] if p.stdout.strip() else ""
    try:
        res = json.loads(line)
    except ValueError:
        res = {"error": p.stderr[-3000:]}
    res.update(rc=p.returncode, seed=seed, trace=trace, wall_s=wall)
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--sets", type=int, default=2)
    p.add_argument("--trace-seeds", default="")
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--timeout", type=float, default=1200.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    seeds = [int(x) for x in args.seeds.split(",") if x]
    out = open(args.out, "a") if args.out else None
    sets = []
    for k in range(args.sets if seeds else 0):
        rows = []
        for s in seeds:
            r = run(args.workload, s, args.seconds, 0, args.timeout)
            r["set"] = k
            rows.append(r)
            line = json.dumps(r)
            print(line[:1500], flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
        sets.append(rows)
    for s in [int(x) for x in args.trace_seeds.split(",") if x]:
        r = run(args.workload, s, args.seconds, 1, args.timeout)
        line = json.dumps(r)
        print(line[:3000], flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    for k, rows in enumerate(sets):
        ok = [r for r in rows if r.get("rc") == 0 and "metrics" in r]
        names = sorted({m for r in ok for m in r["metrics"]})
        for m in names:
            vals = [r["metrics"][m]["value"] for r in ok if m in r["metrics"]]
            if len(vals) >= 2:
                med, sp = spread(vals)
                print(f"set {k} {m}: median {med!r} spread {sp!r} n {len(vals)} "
                      f"values {vals!r}", flush=True)
        print(f"set {k} correct: {[r.get('correct') for r in rows]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
