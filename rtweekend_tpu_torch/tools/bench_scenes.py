"""Per-scene throughput: one scene for each variant of the bounce kernel.

    python -m rtweekend_tpu_torch.tools.bench_scenes [--spp N] [--cpu]

The counterpart of the root `bench_scenes.py`. final_scene, which
bench.py times, exercises the flat-sky sphere path only; these scenes
exercise the rest: all rects (cornell_box), the noise texture
(two_perlin_spheres, simple_light), the image texture (earth) and the
gradient sky (golden_scene). Each renders under its adaptive compaction
schedule (render.adaptive_capacities, computed before any render): a warm
render first (`warm_s`), then one timed render ending in a device sync
(`exec_s`, `rays_per_s` in primary rays), with the bounce-kernel launches
of the timed render. Prints the card's `nvidia-smi` name and power limit,
then one JSON line per scene. Runs on the card unless `--cpu` is given.
"""

from __future__ import annotations

import argparse
import json
import time

from rtweekend_tpu_torch.config import SCENE_DEFAULTS
from rtweekend_tpu_torch.device import describe, resolve_device, synchronize
from rtweekend_tpu_torch.models.builders import build_scene
from rtweekend_tpu_torch.ops.cuda import megakernel as mk
from rtweekend_tpu_torch.render import adaptive_capacities, camera_for_scene, render

# (scene, width, height, spp, depth), as bench_scenes.py
CONFIGS = [
    ("cornell_box", 600, 600, 20, 50),        # all rects, enclosed, emissive
    ("two_perlin_spheres", 600, 400, 20, 50), # Perlin turbulence in the kernel
    ("earth", 600, 400, 20, 50),              # image texture
    ("golden_scene", 600, 400, 20, 50),       # 487 static spheres, gradient sky
    ("simple_light", 600, 400, 20, 50),       # rects + noise + emissive
]
RAYS_PER_CHUNK = 1 << 22


def bench_scene(name, w, h, spp, depth, dev) -> dict:
    """One row: warm render, then the timed one."""
    scene = build_scene(name, device=dev)
    camera = camera_for_scene(name, w / h, dev)
    bg = SCENE_DEFAULTS[name]["background"]
    kwargs = dict(rays_per_chunk=RAYS_PER_CHUNK, capacities=adaptive_capacities(name, bg, depth))
    t0 = time.perf_counter()
    warm = render(scene, camera, w, h, spp, depth, bg, 42, **kwargs)
    synchronize(dev)
    warm_s = time.perf_counter() - t0
    mk.reset_launch_counts()
    t0 = time.perf_counter()
    out = render(scene, camera, w, h, spp, depth, bg, 42, **kwargs)
    synchronize(dev)
    exec_s = time.perf_counter() - t0
    launches = mk.launch_counts()["launches"]
    finite = bool(out.isfinite().all().item() and warm.isfinite().all().item())
    if not finite:
        raise RuntimeError(f"{name}: non-finite radiance")
    return {"scene": name, "size": f"{w}x{h}", "spp": spp, "depth": depth,
            "rays_per_s": round(w * h * spp / exec_s), "exec_s": exec_s, "warm_s": warm_s,
            "launches": launches}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--spp", type=int, default=None, help="override every scene's spp")
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = p.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else None)
    card = describe(dev)
    print(card, flush=True)
    for name, w, h, spp, depth in CONFIGS:
        adaptive_capacities(name, SCENE_DEFAULTS[name]["background"], depth)
    for name, w, h, spp, depth in CONFIGS:
        row = bench_scene(name, w, h, args.spp or spp, depth, dev)
        print(json.dumps({**row, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
