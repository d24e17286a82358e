"""The eager path integrator (rtweekend_tpu.ops.integrator).

The reference integrates by recursion, emitted + attenuation *
rayColor(scattered, depth - 1) (main.zig:103-122); here the recursion is
a loop over bounces with every ray of the batch in flight: per bounce
`radiance += throughput * emitted` (plus `throughput * sky` on a miss)
and `throughput *= attenuation`. Each bounce is the full closest-hit
march (ops/intersect.py), the material scatter (ops/scatter.py) and the
textures (ops/textures.py) as plain tensor ops in the rays' dtype:
float32, or float64, which the bounce kernel does not run. The whole
path is differentiable under autograd; `remat=True` checkpoints each
bounce (torch.utils.checkpoint, non-reentrant), so the backward pass
recomputes a bounce's [rays, primitives] workspaces instead of keeping
max_depth of them.

`accumulate` is the step after a scatter event that the differentiable
replay (ops/replay.py) shares with this loop. `path_decisions` steps the
loop without radiance and returns which rays are alive entering each
bounce and what they hit: the alive fractions of the adaptive compaction
schedule (utils/profiling.alive_fractions) and the paths to hold against
the bounce kernel's winners.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from rtweekend_tpu_torch.models.scene import Scene
from rtweekend_tpu_torch.ops.coeffs import BIG
from rtweekend_tpu_torch.ops.intersect import Hit, closest, intersect, resolve_hit
from rtweekend_tpu_torch.ops.scatter import Scatter, scatter


def sky_color(background, d):
    """Per-ray miss radiance [N, 3] (integrator.py:24-40).

    background [3]: the flat background color (main.zig:110-112),
    broadcast as is. background [2, 3] = (bottom, top): the book-1
    gradient sky, lerped by t = 0.5 * (unit(d).y + 1)."""
    bg = torch.as_tensor(background, dtype=d.dtype, device=d.device)
    if bg.dim() == 1:
        return bg.expand(d.shape)
    d_sq = torch.sum(d * d, dim=-1)
    inv = torch.rsqrt(torch.where(d_sq == 0.0, 1.0, d_sq))
    t = 0.5 * (d[:, 1] * inv + 1.0)
    return (1.0 - t)[:, None] * bg[0] + t[:, None] * bg[1]


def accumulate(background, o, d, hit: Hit, sc: Scatter, throughput, radiance, alive):
    """The integrator's step after a scatter event: (o, d, throughput,
    radiance, alive) of the next bounce. Emission is added before the
    scatter test (main.zig:116-121), the sky on a miss (:110-112)."""
    hit_live = alive & hit.hit
    miss_live = alive & ~hit.hit
    radiance = radiance + torch.where(hit_live[:, None], throughput * sc.emitted, 0.0)
    radiance = radiance + torch.where(miss_live[:, None],
                                      throughput * sky_color(background, d), 0.0)
    new_alive = hit_live & sc.alive
    keep = new_alive[:, None]
    throughput = torch.where(keep, throughput * sc.attenuation, throughput)
    return (torch.where(keep, hit.p, o), torch.where(keep, sc.direction, d), throughput,
            radiance, new_alive)


def _bounce(scene, seed, pixel_ids, sample_ids, times, background, b,
            o, d, throughput, radiance, alive):
    """One bounce of every ray: (o, d, throughput, radiance, alive) after it."""
    hit = intersect(scene, o, d, times)
    sc = scatter(scene, seed, pixel_ids, sample_ids, b, d, hit)
    return accumulate(background, o, d, hit, sc, throughput, radiance, alive)


def trace_paths(scene: Scene, origins, dirs, times, pixel_ids, sample_ids, seed: int,
                background, max_depth: int, *, remat: bool = False):
    """Radiance [N, 3] of camera rays origins/dirs [N, 3], times [N];
    pixel_ids/sample_ids [N] int32 and seed key the counter RNG;
    background is 3 floats or a (bottom, top) pair."""
    seed = int(seed) & 0xFFFFFFFF
    carry = (origins, dirs, torch.ones_like(origins), torch.zeros_like(origins),
             torch.ones(origins.shape[0], dtype=torch.bool, device=origins.device))
    for b in range(max_depth):
        args = (scene, seed, pixel_ids, sample_ids, times, background, b)
        if remat:
            carry = checkpoint(_bounce, *args, *carry, use_reentrant=False)
        else:
            carry = _bounce(*args, *carry)
    return carry[3]


@torch.no_grad()
def path_decisions(scene: Scene, origins, dirs, times, pixel_ids, sample_ids, seed: int,
                   max_depth: int):
    """(alive [max_depth, N] bool: alive entering each bounce, winners
    [max_depth, N] int32: the primitive each ray hits there, -1 for a miss
    or a dead ray), stepping trace_paths's loop without its radiance."""
    seed = int(seed) & 0xFFFFFFFF
    o, d = origins, dirs
    alive = torch.ones(o.shape[0], dtype=torch.bool, device=o.device)
    alives, winners = [], []
    for b in range(max_depth):
        alives.append(alive)
        idx, t_best = closest(scene, o, d, times)
        hit = resolve_hit(scene, o, d, times, idx, t_best < BIG * 0.5, t_best)
        sc = scatter(scene, seed, pixel_ids, sample_ids, b, d, hit)
        winners.append(torch.where(alive & hit.hit, idx, -1))
        alive = alive & hit.hit & sc.alive
        o = torch.where(alive[:, None], hit.p, o)
        d = torch.where(alive[:, None], sc.direction, d)
    return torch.stack(alives), torch.stack(winners).to(torch.int32)
