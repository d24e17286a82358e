"""Device-time report of a torch.profiler Chrome trace
(rtweekend_tpu.utils.trace_report).

Reads the newest `trace_*.json` that utils/profiling.trace wrote (the
CLI's --profile-dir) and totals the device's timeline: every complete
event ("ph" "X") of category kernel, gpu_memcpy or gpu_memset, by kernel
name, by category, and by the host op that launched it (`cpu_op`
events, linked to the device events by their "External id", or through
the launching runtime call's "correlation"). The device events do not
nest, so the totals double count nothing. It answers the question the
JAX tool answered on the TPU: is the kernel hot, or the glue around it?
`phases` splits the trace's busy time into compute, collective and wait
seconds (tools/bench_scaling.py).

    python -m rtweekend_tpu_torch.utils.trace_report DIR [--top N]

or `report(DIR)` -> dict. A trace taken without a card has no device
events: its totals are 0.
"""

from __future__ import annotations

import collections
import glob
import json
import os

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
# host spans of a collective: the c10d op, the backend's own span (gloo's
# runs on its worker thread), the profiler's record of the call
COLLECTIVE_PREFIXES = ("c10d::", "gloo:", "nccl:", "record_param_comms")


def _newest_trace(trace_dir: str) -> str:
    paths = glob.glob(os.path.join(trace_dir, "trace_*.json"))
    if not paths:
        raise FileNotFoundError(f"no trace_*.json under {trace_dir}")
    return max(paths, key=lambda p: (os.path.getmtime(p), p))


def _length_of_union(intervals) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def phases(events, launcher_of=None) -> dict:
    """Busy seconds of a trace split three ways, each instant counted once,
    in this order of precedence:

    - collective_s: host spans of collectives (COLLECTIVE_PREFIXES) and the
      device events of NCCL kernels or launched by a collective op;
    - wait_s: host spans blocked on the device (runtime calls named
      *Synchronize*), outside collectives;
    - compute_s: the other device events; on a trace with no device events
      (a run on the CPU), the host ops (`cpu_op`), outside the two above.

    launcher_of maps a device event to the name of the op that launched it
    (report's linking); without it only kernel names mark collectives."""
    def is_collective(name):
        return name.startswith(COLLECTIVE_PREFIXES)

    coll, wait, dev, host = [], [], [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        name, cat = e.get("name", ""), e.get("cat")
        span = (float(e.get("ts", 0.0)), float(e.get("ts", 0.0)) + float(e.get("dur", 0.0)))
        if cat in DEVICE_CATEGORIES:
            launcher = launcher_of(e) if launcher_of else ""
            if "nccl" in name.lower() or is_collective(launcher):
                coll.append(span)
            else:
                dev.append(span)
        elif is_collective(name):
            coll.append(span)
        elif cat == "cuda_runtime" and "Synchronize" in name:
            wait.append(span)
        elif cat == "cpu_op":
            host.append(span)
    c = _length_of_union(coll)
    cw = _length_of_union(coll + wait)
    work = dev if dev else host
    return {"compute_s": (_length_of_union(coll + wait + work) - cw) / 1e6,
            "collective_s": c / 1e6, "wait_s": (cw - c) / 1e6}


def report(trace_dir: str, top: int = 15) -> dict:
    """Device seconds in total and the `top` largest by kernel name
    (`by_kernel`), by category (`by_category`) and by launching host op
    (`by_launcher`; "?" where no op is linked) of the newest trace in
    trace_dir, and its `phases`. Raises FileNotFoundError when there is
    none."""
    path = _newest_trace(trace_dir)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    op_of = {}        # External id -> cpu_op name
    runtime_ext = {}  # correlation -> External id of the launching runtime call
    for e in events:
        args = e.get("args") or {}
        if e.get("cat") == "cpu_op" and "External id" in args:
            op_of[args["External id"]] = e["name"]
        elif e.get("cat") == "cuda_runtime" and "correlation" in args:
            runtime_ext[args["correlation"]] = args.get("External id")
    by_kernel = collections.Counter()
    by_cat = collections.Counter()
    by_launcher = collections.Counter()
    total_us = 0.0

    def launcher_of(e):
        args = e.get("args") or {}
        ext = args.get("External id")
        if ext not in op_of:
            ext = runtime_ext.get(args.get("correlation"))
        return op_of.get(ext, "?")

    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATEGORIES:
            continue
        us = float(e.get("dur", 0.0))
        total_us += us
        by_kernel[e["name"]] += us
        by_cat[e["cat"]] += us
        by_launcher[launcher_of(e)] += us

    def seconds(c):
        return {k: us / 1e6 for k, us in c.most_common(top)}

    return {
        "trace": os.path.basename(path),
        "device_total_s": total_us / 1e6,
        "by_kernel": seconds(by_kernel),
        "by_category": seconds(by_cat),
        "by_launcher": seconds(by_launcher),
        "phases": phases(events, launcher_of),
    }


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("trace_dir")
    p.add_argument("--top", type=int, default=15)
    args = p.parse_args(argv)
    print(json.dumps(report(args.trace_dir, args.top), indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
