"""Gradient Perlin noise with turbulence (reference src/rtw/perlin.zig).

`make_tables` is the host-side table generation the scene builders
store (perlin.zig:18-38). `noise` and `turb` evaluate the noise at a
batch of points with plain tensor ops, differentiable in the points:
the differentiable replay's noise texture uses them. The bounce kernel
and its plain version keep their own copy in the TPU kernel's operation
order (ops/cuda/megakernel.perlin_turb).
"""

from __future__ import annotations

import numpy as np
import torch

POINT_COUNT = 256  # reference src/rtw/perlin.zig:11


def make_tables(seed: int, dtype=np.float32):
    """256 unit gradients (a uniform cube sample normalized, vec.zig:89-101)
    and three Fisher-Yates permutations, from a seeded numpy generator —
    the same draws as rtweekend_tpu.utils.perlin.make_tables."""
    g = np.random.default_rng(seed)
    v = g.uniform(-1.0, 1.0, size=(POINT_COUNT, 3))
    n = np.linalg.norm(v, axis=-1, keepdims=True)
    grad = (v / np.where(n == 0, 1.0, n)).astype(dtype)
    perm_x = g.permutation(POINT_COUNT).astype(np.int32)
    perm_y = g.permutation(POINT_COUNT).astype(np.int32)
    perm_z = g.permutation(POINT_COUNT).astype(np.int32)
    return grad, perm_x, perm_y, perm_z


def noise(grad, perm_x, perm_y, perm_z, p):
    """Perlin noise at points p [..., 3] (perlin.zig:47-78): gradient dots
    at the 8 lattice corners, Hermite-smoothed trilinear weights."""
    pf = torch.floor(p)
    uvw = p - pf
    ijk = pf.to(torch.int32)
    s = uvw * uvw * (3.0 - 2.0 * uvw)
    accum = torch.zeros(p.shape[:-1], dtype=p.dtype, device=p.device)
    corners = torch.tensor([[di, dj, dk] for di in range(2) for dj in range(2)
                            for dk in range(2)], dtype=p.dtype, device=p.device)
    for di in range(2):
        for dj in range(2):
            for dk in range(2):
                ix = ((ijk[..., 0] + di) & 255).long()
                iy = ((ijk[..., 1] + dj) & 255).long()
                iz = ((ijk[..., 2] + dk) & 255).long()
                gi = (perm_x[ix] ^ perm_y[iy] ^ perm_z[iz]).long()
                c = grad[gi]
                weight = uvw - corners[4 * di + 2 * dj + dk]
                w = (
                    (di * s[..., 0] + (1 - di) * (1.0 - s[..., 0]))
                    * (dj * s[..., 1] + (1 - dj) * (1.0 - s[..., 1]))
                    * (dk * s[..., 2] + (1 - dk) * (1.0 - s[..., 2]))
                )
                accum = accum + w * torch.sum(c * weight, dim=-1)
    return accum


def turb(grad, perm_x, perm_y, perm_z, p, depth: int = 7):
    """|sum over `depth` octaves of 2^-k noise(2^k p)| (perlin.zig:80-91)."""
    accum = torch.zeros(p.shape[:-1], dtype=p.dtype, device=p.device)
    weight = 1.0
    q = p
    for _ in range(depth):
        accum = accum + weight * noise(grad, perm_x, perm_y, perm_z, q)
        weight *= 0.5
        q = q * 2.0
    return torch.abs(accum)
