"""The card's arithmetic for rooflines: the peaks of one H100 and the
operations the bounce kernel (csrc/megakernel.cu) does per unit of work.

Used by chip_smoke.segment_bound (the least time of one launch on its
data) and tools/bench.py (the speed of light of a whole render).
"""

from __future__ import annotations

# H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor cores, HBM
FP32_FLOPS = 67e12
HBM_BYTES_S = 3.35e12

# arithmetic operations of the texture work per live hit (noise, image)
# and of the gradient sky per live miss, counted from csrc/megakernel.cu
# (its source note lists the terms)
NOISE_OPS, IMAGE_OPS, SKY_OPS = 1338, 118, 15

# features of one coefficient row: the closest-hit march is one 17-term
# multiply-add chain per row and ray
COEF_FEATURES = 17


def coef_rows(spheres: int, rects: int) -> int:
    """Coefficient rows of the march: 2 a sphere, 6 a rect."""
    return 2 * spheres + 6 * rects


def march_flop(spheres: int, rects: int) -> int:
    """FLOP of the closest-hit march for one ray-bounce (one lane-bounce):
    17 multiply-adds (2 FLOP each) per coefficient row, plus the 2-FLOP
    discriminant per sphere."""
    return 2 * COEF_FEATURES * coef_rows(spheres, rects) + 2 * spheres
