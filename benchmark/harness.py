"""One run of one cell: set-up, the measured window, the check against
the reference, the metrics, and the result line.

Everything that belongs to one cell is found by name: the cell's entry
in BENCHMARK.json, its configuration `configs/<config>.json`, its
traffic `workloads/<cell>.json`, the job that drives it
`jobs/<job>.py`, and one reader `metrics/<metric>.py` per per-layer
metric. Adding a cell or a metric adds files; it edits none.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "rtweekend_tpu")


class Context:
    """What a per-layer reader reads: the cell, the job's counters, the
    trace of the window and the reference's work counts."""

    def __init__(self, cell, cfg, wl, stats, trace, work):
        self.cell, self.cfg, self.wl = cell, cfg, wl
        self.stats, self.trace, self.work = stats, trace, work


def manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell_parts(name: str, root: Path = ROOT):
    """(cell entry, configuration, workload, job module) of a cell."""
    man = manifest(root)
    cells = {w["name"]: w for w in man["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; have {sorted(cells)}")
    cell = cells[name]
    cfg = json.loads((HERE / "configs" / f"{cell['config']}.json").read_text())
    wl = json.loads((HERE / "workloads" / f"{name}.json").read_text())
    job = importlib.import_module(f"benchmark.jobs.{wl['job']}")
    return man, cell, cfg, wl, job


def metrics_of(man: dict, cell: str, kind: str) -> list:
    """The metrics of `kind` ("end_to_end" or "per_layer") the cell reports."""
    return [m for m in man[kind] if cell in m.get("workloads", [cell])]


def reader(name: str):
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}",
                                                  HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def program_builds(dev) -> float:
    """Load the program's compiled libraries (the kernels nvcc builds, the
    PNG library) and return the seconds spent compiling them: 0 where a
    run in this checkout built them before."""
    from rtweekend_tpu_torch.utils import native

    seconds = native.load()[1].seconds
    if dev.type == "cuda":
        from rtweekend_tpu_torch.ops.cuda import build

        seconds += build.load()[1].seconds
    return seconds


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def run_cell(name: str, seed: int, seconds: float, trace: bool, *, t_start: float,
             device=None, parts=None, control: bool = False, detail: dict | None = None):
    """The result of one run, with the numbers compared beside their limits
    under "compared". `device` defaults to the card; `parts` replaces
    cell_parts(name) (the tests run cells at small sizes on the CPU);
    `control` puts the reference, computed one precision step down, in
    the program's place in the check; `detail`, if a dict, receives the
    job's stats."""
    man, cell, cfg, wl, job_mod = parts or cell_parts(name)
    dev = torch.device(device) if device is not None else torch.device("cuda")
    outdir = Path(tempfile.mkdtemp(prefix="rtw_bench_"))
    try:
        build_s = program_builds(dev)
        job = job_mod.Job(cfg, wl, seed, dev, outdir, trace)
        job.setup()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        # the benchmark's own reference work in set-up (a target image) is
        # no set-up of the program
        ref_s = job.stats.get("reference_setup_s", 0.0)
        setup_s = time.perf_counter() - t_start - ref_s
        prof = tr = None
        if trace:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if dev.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.start()
        with torch.profiler.record_function("bench_window"):
            job.window(seconds, wl["trace_units"] if trace else None)
            if dev.type == "cuda":
                torch.cuda.synchronize()
        if prof is not None:
            prof.stop()
            from benchmark.trace import from_profiler
            tr = from_profiler(prof)
            del prof
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        e2e = job.end_to_end()
        attempted, failed = job.attempted_failed()
        job.release()
        numbers, work = job.check(control=control)
    finally:
        shutil.rmtree(outdir, ignore_errors=True)

    if detail is not None:
        detail.update(job.stats)
    limits = wl["limits"]
    compared = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    correct = failed == 0 and all(v <= limits[k] for k, v in numbers.items())
    metrics = {}
    if trace:
        ctx = Context(name, cfg, wl, job.stats, tr, work)
        for m in metrics_of(man, name, "per_layer"):
            v = reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in metrics_of(man, name, "end_to_end"):
            v = setup_s if m["name"] == "setup_s" else e2e.get(m["name"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                         "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda"
                         else "cpu",
                         "count": cell["chips"], "memory_peak_bytes": peak}}
    if tr is not None:
        result["device"].update(busy_s=tr.busy_s(), window_s=tr.window_s)
        result["breakdown"] = tr.breakdown()
    # recorded apart, and inside setup_s: compilation on a checkout's first
    # run; outside it: the benchmark's own reference work
    result["setup_parts"] = {"build_s": build_s, "reference_setup_s": ref_s}
    result["compared"] = compared
    return result
