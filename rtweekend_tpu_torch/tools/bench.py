"""Headline benchmark: primary rays/s of the book-cover final_scene at
1200x675 on one card, its roofline, and the rays/s of a gradient step.

    python -m rtweekend_tpu_torch.tools.bench [--cpu]

The counterpart of the root `bench.py`. It renders final_scene at
SPP_MEASURE samples, depth 50, under the scene's adaptive compaction
schedule (what render_image and the CLI use): a warm-up render (`warm_s`),
then a timed render ending in a device sync (`exec_s`). The headline line

    {"metric": "rays_per_s_card_final_scene_1200x675", "value", "unit",
     "warm_s", "exec_s", "card"}

is printed as soon as the timed render ends. Then one line with the
headline and:

- the roofline: the ray-bounces the render's rays are alive for
  (`live_ray_bounces`, counted on this run's rays), the march's FLOP per
  primary ray over them and the scene's real primitives
  (utils/roofline.march_flop), `sol_rays_per_s`, the rays/s if the FP32
  units ran that march at their peak, and `pct_of_sol`. The bounce kernel
  (csrc/megakernel.cu) marches live rays only: its persistent blocks pass
  dead lanes through and refill finished rays, as chip_smoke.segment_bound
  counts its work. `executed_lane_bounces` is bench.py's count for the
  TPU kernel, which marches every lane of a segment's buffer (capacity x
  segment length summed over the segments of every batch), reported
  beside it. The march runs on the FP32 units, not on tensor cores;
- `fwd_bwd_rays_per_s`: primary rays/s of a forward and backward pass of
  grad.make_loss (final_scene 400x225, 4 spp, depth 16, seed 7, target
  zeros), by torch.autograd.grad over shard.extract_params, the median
  of 3 steps after two warm-up steps.

"rays" counts camera samples. Runs on the card unless `--cpu` is given;
a CPU run names its metric rays_per_s_cpu_... and leaves `pct_of_sol`
"not measured".
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import time

import torch

from rtweekend_tpu_torch.device import describe, resolve_device, synchronize
from rtweekend_tpu_torch.grad import make_loss
from rtweekend_tpu_torch.models.builders import build_scene
from rtweekend_tpu_torch.ops.camera import batch_rays
from rtweekend_tpu_torch.ops.cuda import megakernel as mk
from rtweekend_tpu_torch.parallel.shard import extract_params
from rtweekend_tpu_torch.render import adaptive_capacities, batch_size, camera_for_scene, render
from rtweekend_tpu_torch.utils.roofline import FP32_FLOPS, march_flop

SCENE = "final_scene"
WIDTH, HEIGHT = 1200, 675
SPP_MEASURE = 40
MAX_DEPTH = 50
RAYS_PER_CHUNK = 1 << 22
BACKGROUND = (0.70, 0.80, 1.00)
SEED = 42
# the gradient step: width, height, spp, depth, seed
FWD_BWD = (400, 225, 4, 16, 7)


def _executed_lane_bounces(n_rays_batch, n_batches, max_depth, capacities):
    """Lane-bounces the compacted render path executes per full render: the sum
    over the segments of megakernel.schedule of capacity x segment length
    (bench.py's count: every lane of a segment's buffer, alive or not)."""
    segs = mk.schedule(n_rays_batch, max_depth, capacities)
    return sum(cap * n_b for _, n_b, cap in segs) * n_batches


def _live_ray_bounces(scene, camera, seed: int) -> int:
    """Ray-bounces the headline render's rays are alive for: the rays of
    each sample batch stepped through the bounce kernel one bounce at a
    time, uncompacted (compaction drops no live ray, and render re-traces
    a batch whose schedule overflowed), the live rays counted entering
    each bounce. These launches are not the render's."""
    tables = mk.pack_scene(scene)
    batch = batch_size(WIDTH * HEIGHT, SPP_MEASURE, RAYS_PER_CHUNK)
    total = 0
    for start in range(0, SPP_MEASURE, batch):
        state = mk.init_state(*batch_rays(camera, seed, start, width=WIDTH, height=HEIGHT,
                                          n_samples=batch))
        scratch = torch.zeros((3, state.shape[0]), device=state.device)   # not read
        for b in range(MAX_DEPTH):
            live = int((state[:, mk.S_AL] > 0.5).sum().item())
            if live == 0:
                break
            total += live
            state = mk.trace_segment(tables, state, seed, BACKGROUND, b, 1, accum=scratch)
    return total


def roofline(scene, camera, n_rays: int, rays_per_s, capacities) -> dict:
    """The march's speed of light on the card for this render: FLOP per
    primary ray of its live ray-bounces at the FP32 peak, and the share
    of it that rays_per_s reaches ("not measured" for a run off the
    card, whose rays_per_s is None)."""
    spheres = int(scene.spheres.active.sum().item())
    rects = int(scene.rects.active.sum().item())
    n_pix = WIDTH * HEIGHT
    batch = batch_size(n_pix, SPP_MEASURE, RAYS_PER_CHUNK) * n_pix
    lane_bounces = _executed_lane_bounces(batch, -(-n_rays // batch), MAX_DEPTH, capacities)
    live = _live_ray_bounces(scene, camera, SEED)
    flop_per_ray = live * march_flop(spheres, rects) / n_rays
    sol = FP32_FLOPS / flop_per_ray
    return {
        "spheres": spheres, "rects": rects, "live_ray_bounces": live,
        "executed_lane_bounces": lane_bounces,
        "flop_per_ray": flop_per_ray, "fp32_peak_flops": FP32_FLOPS,
        "sol_rays_per_s": round(sol),
        "pct_of_sol": "not measured" if rays_per_s is None else 100.0 * rays_per_s / sol,
    }


def fwd_bwd_rays_per_s(dev) -> float:
    """Primary rays/s of one value-and-gradient step of the mean-radiance
    MSE (kernel winners, then the differentiable replay)."""
    w, h, spp, depth, seed = FWD_BWD
    scene = build_scene(SCENE, device=dev)
    camera = camera_for_scene(SCENE, w / h, dev)
    target = torch.zeros((h, w, 3), dtype=torch.float32, device=dev)
    loss_fn = make_loss(scene, camera, target, BACKGROUND, seed, width=w, height=h, spp=spp,
                        max_depth=depth)
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in extract_params(scene).items()}

    def step():
        loss = loss_fn(params)
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        total = float(loss.detach()) + sum(float(g.sum()) for g in grads if g is not None)
        if not math.isfinite(total):
            raise RuntimeError(f"fwd_bwd: non-finite loss or gradient ({total})")

    times = []
    for i in range(5):   # two warm-up steps, then three timed
        synchronize(dev)
        t0 = time.perf_counter()
        step()
        if i >= 2:
            times.append(time.perf_counter() - t0)
    return w * h * spp / statistics.median(times)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = p.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else None)
    card = describe(dev)
    scene = build_scene(SCENE, device=dev)
    camera = camera_for_scene(SCENE, WIDTH / HEIGHT, dev)
    caps = adaptive_capacities(SCENE, BACKGROUND, MAX_DEPTH)
    kwargs = dict(rays_per_chunk=RAYS_PER_CHUNK, capacities=caps)
    call = (scene, camera, WIDTH, HEIGHT, SPP_MEASURE, MAX_DEPTH, BACKGROUND, SEED)

    t0 = time.perf_counter()
    warm_sum = float(render(*call, **kwargs).sum())   # float() waits for the device
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    accum = render(*call, **kwargs)
    synchronize(dev)
    exec_s = time.perf_counter() - t0
    if not (math.isfinite(warm_sum) and math.isfinite(float(accum.sum()))):
        raise RuntimeError("bench: non-finite radiance")
    n_rays = WIDTH * HEIGHT * SPP_MEASURE
    rays_per_s = n_rays / exec_s
    result = {
        "metric": f"rays_per_s_{'card' if dev.type == 'cuda' else 'cpu'}_{SCENE}_{WIDTH}x{HEIGHT}",
        "value": round(rays_per_s, 1),
        "unit": "primary_rays/s",
        "warm_s": warm_s,
        "exec_s": exec_s,
        "card": card,
    }
    print(json.dumps(result), flush=True)   # the headline, before anything else can fail

    result.update(roofline(scene, camera, n_rays, rays_per_s if dev.type == "cuda" else None,
                           caps))
    result["fwd_bwd_rays_per_s"] = round(fwd_bwd_rays_per_s(dev))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
