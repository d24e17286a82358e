"""Pieces of the eager path integrator (rtweekend_tpu.ops.integrator).

Only `sky_color` is ported so far: the differentiable replay
(ops/replay.py) uses it for misses. The eager integrator itself
(`trace_paths`, `trace_paths_replay`, with intersect, textures and
scatter) waits for ROADMAP Queue 1 #8.
"""

from __future__ import annotations

import torch


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
