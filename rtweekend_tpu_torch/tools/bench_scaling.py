"""Weak scaling over ranks of torch.distributed, with a phase breakdown
read from a profiler trace.

    python -m rtweekend_tpu_torch.tools.bench_scaling [--backend cpu|cuda]
        [--max-ranks K] [--ranks-per-card N] [--train] [--out PATH]

The counterpart of the root `bench_scaling.py`. Weak scaling on the sample
axis: k ranks on a (1, k) mesh (parallel/mesh.make_mesh) each trace the
full pixel grid at `--spp-per-device` samples, spp = that times k, so the
work a rank does stays the same and ideal scaling is rays/s proportional
to k. k runs over 1, 2, 4, 8, ... up to `--max-ranks`; each k is a fresh
group of k processes (torch.multiprocessing, spawn), started after this
process has built the kernel. A rank times `--repeats` runs of
shard.render_sharded (or, with `--train`, of shard.sharded_train_step)
after a warm-up run; rank 0 then traces one more run under
utils/profiling.trace, which utils/trace_report.report splits into
compute, collective and wait seconds. A group that outlasts `--timeout`
seconds is killed and the tool fails.

Backends:
- cpu: gloo ranks on the host's cores (each takes cores / k threads), the
  analog of the JAX tool's virtual CPU devices. Efficiency beyond
  k = cores is bounded by cores / k (`core_ceiling`) by construction;
- cuda: one rank per card over NCCL, or `--ranks-per-card N` ranks sharing
  each card over gloo (NCCL refuses two ranks on one card). Ranks that
  share a card time-share it, so on one card this measures the sharded
  layer's overhead and the collective share of a step, not scaling
  (`core_ceiling` = min(1, cards / k)).

Prints one JSON line per k and a summary; `--out` writes both to a file.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import tempfile
import time

import torch

RESULT = "rank{}.json"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank(rank: int, k: int, port: int, cfg: dict, out_dir: str) -> None:
    """One rank of a group of k (started by torch.multiprocessing): warm-up
    run, `repeats` timed runs, one more run (traced on rank 0); writes
    its results to <out_dir>/rank<rank>.json."""
    import torch.distributed as dist

    from rtweekend_tpu_torch.config import SCENE_DEFAULTS
    from rtweekend_tpu_torch.device import synchronize
    from rtweekend_tpu_torch.models.builders import build_scene
    from rtweekend_tpu_torch.parallel import multihost, shard
    from rtweekend_tpu_torch.parallel.mesh import make_mesh
    from rtweekend_tpu_torch.render import camera_for_scene
    from rtweekend_tpu_torch.utils import trace_report
    from rtweekend_tpu_torch.utils.profiling import trace

    device = "cpu" if cfg["backend"] == "cpu" else None
    if device == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // k))
    else:
        os.environ["LOCAL_RANK"] = str(rank // cfg["ranks_per_card"])
    dev = multihost.initialize(f"127.0.0.1:{port}", k, rank, device=device,
                               backend=cfg["dist_backend"])
    mesh = make_mesh((1, k), device=device)
    name, w, h, depth = cfg["scene"], cfg["width"], cfg["height"], cfg["max_depth"]
    spp = cfg["spp_per_device"] * k
    scene = build_scene(name, seed=42, device=dev)
    camera = camera_for_scene(name, w / h, dev)
    bg = SCENE_DEFAULTS[name]["background"]
    if cfg["train"]:
        target = torch.zeros((h, w, 3), dtype=torch.float32, device=dev)

        def run():
            return shard.sharded_train_step(scene, camera, target, w, h, spp, depth, bg, 42,
                                            mesh)[1]
    else:
        def run():
            return shard.render_sharded(scene, camera, w, h, spp, depth, bg, 42, mesh)

    def timed(n):
        dist.barrier()
        synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(n):
            out = run()
        synchronize(dev)
        if not bool(torch.isfinite(out).all()):
            raise RuntimeError(f"rank {rank}: non-finite output")
        return (time.perf_counter() - t0) / n

    timed(1)   # warm-up: the card's code loads lazily, NCCL builds its communicator
    step_s = timed(cfg["repeats"])
    res = {"rank": rank, "device": str(dev), "backend": dist.get_backend(), "step_s": step_s}
    if rank == 0:
        with tempfile.TemporaryDirectory() as td:
            with trace(td):
                timed(1)
            res["phases"] = trace_report.report(td)["phases"]
    else:
        timed(1)
    with open(os.path.join(out_dir, RESULT.format(rank)), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


def run_group(k: int, cfg: dict, timeout: float) -> list:
    """Start k ranks, wait at most `timeout` seconds (then kill every rank
    and raise), return their results by rank."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as out_dir:
        ctx = mp.start_processes(_rank, args=(k, _free_port(), cfg, out_dir), nprocs=k,
                                 join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    raise RuntimeError(f"{k} ranks: not done after {timeout} s; killed")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        results = []
        for r in range(k):
            with open(os.path.join(out_dir, RESULT.format(r))) as f:
                results.append(json.load(f))
    return results


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--scene", default="final_scene")
    p.add_argument("--width", type=int, default=256)
    p.add_argument("--height", type=int, default=144)
    p.add_argument("--spp-per-device", type=int, default=4)
    p.add_argument("--max-depth", type=int, default=8)
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--train", action="store_true",
                   help="time sharded_train_step (forward, backward, gradient all-reduce) "
                        "instead of render_sharded")
    p.add_argument("--backend", default="cuda", choices=["cpu", "cuda"],
                   help="cpu: gloo ranks on the host's cores; cuda: ranks on the cards")
    p.add_argument("--ranks-per-card", type=int, default=1,
                   help="ranks sharing each card (over gloo when > 1)")
    p.add_argument("--max-ranks", type=int, default=None,
                   help="largest k (default: 8 on the CPU, cards x ranks-per-card)")
    p.add_argument("--timeout", type=float, default=600.0,
                   help="seconds a group of ranks may take before it is killed")
    p.add_argument("--out", default=None, help="write the rows and summary as JSON")
    args = p.parse_args(argv)

    cores = os.cpu_count() or 1
    if args.backend == "cuda":
        from rtweekend_tpu_torch.device import describe, resolve_device
        from rtweekend_tpu_torch.ops.cuda import build

        card = describe(resolve_device(None))
        cards = torch.cuda.device_count()
        slots = cards * args.ranks_per_card
        build.load()   # the ranks load the library built here
        dist_backend = "nccl" if args.ranks_per_card == 1 else "gloo"
    else:
        card, cards, slots, dist_backend = "cpu", 0, None, "gloo"
    max_ranks = args.max_ranks or (slots or 8)
    if slots is not None and max_ranks > slots:
        raise ValueError(f"--max-ranks {max_ranks} > {cards} card(s) x "
                         f"{args.ranks_per_card} ranks a card")
    cfg = dict(scene=args.scene, width=args.width, height=args.height,
               spp_per_device=args.spp_per_device, max_depth=args.max_depth,
               repeats=args.repeats, train=args.train, backend=args.backend,
               ranks_per_card=args.ranks_per_card, dist_backend=dist_backend)
    sizes = [k for k in (1, 2, 4, 8, 16, 32, 64) if k <= max_ranks]
    rates, rows = {}, []
    for k in sizes:
        res = run_group(k, cfg, args.timeout)
        step_s = max(r["step_s"] for r in res)   # the slowest rank sets the step
        spp = args.spp_per_device * k
        rates[k] = args.width * args.height * spp / step_s
        phases = res[0]["phases"]
        busy = sum(phases.values())
        row = {
            "devices": k, "spp": spp, "rays_per_s": round(rates[k]), "step_s": step_s,
            "efficiency_vs_1dev": rates[k] / (k * rates[sizes[0]]),
            "core_ceiling": min(1.0, (cards if args.backend == "cuda" else cores) / k),
            "phases_per_device": phases,
            "collective_frac_of_busy": phases["collective_s"] / busy if busy else None,
            "backend": res[0]["backend"], "rank_devices": [r["device"] for r in res],
            "card": card,
        }
        rows.append(row)
        print(json.dumps(row), flush=True)

    kmax = sizes[-1]
    ratio = rates[kmax] / rates[sizes[0]]
    if args.backend == "cuda":
        note = (f"{kmax} ranks on {cards} card(s), {args.ranks_per_card} a card over "
                f"{dist_backend}: ranks that share a card time-share it, so this measures the "
                "sharded layer's overhead and the collective share of a step, not scaling")
    else:
        note = (f"{kmax} gloo ranks share the host's {cores} cores (cores / k threads a "
                "rank): efficiency beyond k = cores is bounded by cores / k by construction; "
                "the collective share of busy time is what the sharding itself costs")
    summary = {
        "metric": f"weak_scaling_efficiency_{kmax}ranks_{args.backend}"
                  + ("_train" if args.train else ""),
        "value": ratio / kmax,
        "unit": "fraction_of_linear",
        "host_cores": cores,
        "cards": cards,
        "aggregate_throughput_ratio_kmax_vs_1": ratio,
        "max_collective_frac_of_busy": max((r["collective_frac_of_busy"] or 0.0) for r in rows),
        "per_device_compute_s_1_vs_kmax": [rows[0]["phases_per_device"]["compute_s"],
                                           rows[-1]["phases_per_device"]["compute_s"]],
        "note": note,
        "card": card,
    }
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"rows": rows, "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
