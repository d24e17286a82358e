"""Time render_image under the adaptive compaction schedule (its own,
since it is given no capacities) against the static one, alternated:

    python -m rtweekend_tpu_torch.tools.schedule_ab [--pairs N] [--spp S] [scene ...]

Card only. Scenes default to final_scene and golden_scene, each at its
default size, depth 50. Per scene, in one process with the kernel built
and loaded first:

- `cold_s`: render_image's first call for the scene, the schedule's CPU
  probe included (what one CLI invocation pays besides start-up);
- `probe_s` and `fractions`: the probe alone, timed again, and the alive
  fraction entering each bounce it measured; both schedules;
- one warm-up frame under each schedule, then N pairs in alternating
  order (A S, S A, ...): host wall seconds each, ending in a sync, as
  median, minimum and maximum, with the median of the per-pair ratios;
  launches a frame; framebuffers bit-equal;
- two profiled frames under each schedule (A S S A), from
  utils/profiling.device_profile: device busy ms, idle share, the bounce
  kernel's ms and the costliest kernels.

One JSON line per scene; the card's `nvidia-smi` name and power limit
first.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

from rtweekend_tpu_torch import render as render_mod
from rtweekend_tpu_torch.config import SCENE_DEFAULTS, RenderConfig
from rtweekend_tpu_torch.device import describe
from rtweekend_tpu_torch.ops.cuda import build
from rtweekend_tpu_torch.ops.cuda import megakernel as mk
from rtweekend_tpu_torch.utils.profiling import device_profile


def frame(cfg, caps):
    """(wall s, launches, framebuffer) of one render_image; caps None is
    render_image's own schedule, the adaptive one."""
    torch.cuda.synchronize()
    mk.reset_launch_counts()
    t0 = time.perf_counter()
    _, fb = render_mod.render_image(cfg, capacities=caps)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, mk.launch_counts()["launches"], fb


def spread(xs):
    return dict(median=statistics.median(xs), min=min(xs), max=max(xs), n=len(xs))


def ab(name: str, pairs: int, spp: int, depth: int, card: str) -> dict:
    p = SCENE_DEFAULTS[name]
    cfg = RenderConfig(scene=name, width=p["width"], height=p["height"],
                       samples_per_pixel=spp, max_depth=depth)
    render_mod._ADAPTIVE_CAPS_CACHE.clear()
    cold_s, _, _ = frame(cfg, None)
    t0 = time.perf_counter()
    fracs = render_mod.probe_fractions(name, depth)
    probe_s = time.perf_counter() - t0
    adaptive = render_mod.adaptive_capacities(name, p["background"], depth)
    static = render_mod._capacities_for(p["background"])

    frame(cfg, static)
    frame(cfg, None)
    walls = {"adaptive": [], "static": []}
    launches, ratios, bit_equal = {}, [], True
    for i in range(pairs):
        order = ("adaptive", "static") if i % 2 == 0 else ("static", "adaptive")
        fbs = {}
        for which in order:
            wall, launches[which], fbs[which] = frame(
                cfg, static if which == "static" else None)
            walls[which].append(wall)
        ratios.append(walls["adaptive"][-1] / walls["static"][-1])
        bit_equal &= bool(torch.equal(fbs["adaptive"], fbs["static"]))

    prof = {"adaptive": [], "static": []}
    for which in ("adaptive", "static", "static", "adaptive"):
        caps = static if which == "static" else None
        prof[which].append(device_profile(lambda: render_mod.render_image(cfg, capacities=caps)))
    busy = {k: [pr["device_busy_ms"] for pr in v] for k, v in prof.items()}
    return dict(
        scene=name, width=cfg.width, height=cfg.height, spp=spp, depth=depth,
        cold_s=cold_s, primary_rays=cfg.width * cfg.height * spp, probe_s=probe_s,
        fractions=fracs, adaptive=adaptive, static=static, launches=launches,
        wall_s={k: spread(v) for k, v in walls.items()}, walls=walls,
        ratio_adaptive_over_static=spread(ratios), bit_equal=bit_equal,
        device_busy_ms=busy,
        idle_share={k: [pr["idle_share"] for pr in v] for k, v in prof.items()},
        bounce_kernel_ms={k: [pr.get("bounce_kernel_ms") for pr in v]
                          for k, v in prof.items()},
        top_kernels={k: v[0].get("top_kernels") for k, v in prof.items()},
        card=card,
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("scenes", nargs="*", default=["final_scene", "golden_scene"])
    ap.add_argument("--pairs", type=int, default=12)
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--depth", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("schedule_ab: no CUDA device")
        return 2
    card = describe(torch.device("cuda"))
    print(card, flush=True)
    build.load()
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    for name in args.scenes:
        print(json.dumps(ab(name, args.pairs, args.spp, args.depth, card)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
