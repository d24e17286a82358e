"""Seeds the benchmark derives from a run's --seed: one per frame, step
or sample, so that no result repeats within a run."""

from __future__ import annotations

import hashlib

import numpy as np


def derive(seed: int, *keys) -> int:
    """A seed in [0, 2^31) for (seed, *keys)."""
    h = hashlib.blake2b(repr((int(seed),) + keys).encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") & 0x7FFFFFFF


def rng(seed: int, *keys) -> np.random.Generator:
    return np.random.default_rng(derive(seed, *keys))
