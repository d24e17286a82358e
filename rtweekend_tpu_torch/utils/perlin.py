"""Perlin tables (reference src/rtw/perlin.zig:18-38).

Only the host-side table generation is ported so far: the scene builders
store the tables. Evaluation (noise/turb) belongs to the Perlin kernel
variant, which a later slice ports."""

from __future__ import annotations

import numpy as np

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
