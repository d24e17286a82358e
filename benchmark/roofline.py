"""The yardstick of the bounce kernel's roofline: the published peaks of
one H100 and the work the kernel's algorithm needs, counted by the
benchmark.

The operations are those of the program's roofline arithmetic
(`march_flop`, `coef_rows`, and the texture and sky terms counted from
the kernel source), copied here so that the program cannot move them:
per live ray-bounce, 17 multiply-adds (2 FLOP each) over each of the
2 S + 6 R coefficient rows of the scene's real spheres and rects and the
2-FLOP discriminant of each real sphere; per live hit on a noise or image
texture its texture work; per live miss under the gradient sky its sky
work. Live ray-bounces and misses come from the benchmark's reference,
which traces a sample of the cell's own rays: the count does not depend
on how the program traces them, nor on its buffers.

The bytes are the least any implementation moves: each ray's state
(14 words) read once and its radiance (3 words) written once, and the
scene's real tables read once per frame. The least time is the larger of
operations at the FP32 peak and bytes at the HBM rate.
"""

from __future__ import annotations

# H100 SXM (NVIDIA data sheet): FP32 outside the tensor cores; HBM3
FP32_FLOPS = 67e12
HBM_BYTES_S = 3.35e12

# operations per live hit on a noise or image texture, per live miss
# under the gradient sky (csrc/megakernel.cu's own count of its terms)
NOISE_OPS, IMAGE_OPS, SKY_OPS = 1338, 118, 15
COEF_FEATURES = 17
STATE_WORDS, RADIANCE_WORDS = 14, 3
# attribute words a primitive carries (29 float, 5 int)
ATTR_WORDS = 34


def coef_rows(spheres: int, rects: int) -> int:
    """Coefficient rows of the closest-hit march: 2 a sphere, 6 a rect."""
    return 2 * spheres + 6 * rects


def march_flop(spheres: int, rects: int) -> int:
    """FLOP of the closest-hit march for one live ray-bounce."""
    return 2 * COEF_FEATURES * coef_rows(spheres, rects) + 2 * spheres


def least_seconds(*, rays: int, live_ray_bounces: float, live_misses: float,
                  spheres: int, rects: int = 0, has_sky: bool = False,
                  noise_hits: float = 0.0, image_hits: float = 0.0, frames: int = 1) -> dict:
    """Operations, bytes and the least time of tracing `rays` rays that
    make `live_ray_bounces` live ray-bounces (and the live misses and
    texture hits given) over `frames` frames of one scene."""
    ops = (live_ray_bounces * march_flop(spheres, rects) + noise_hits * NOISE_OPS
           + image_hits * IMAGE_OPS + (live_misses * SKY_OPS if has_sky else 0.0))
    table = (coef_rows(spheres, rects) * COEF_FEATURES + ATTR_WORDS * (spheres + rects)) * 4
    nbytes = rays * (STATE_WORDS + RADIANCE_WORDS) * 4 + frames * table
    ops_s, bytes_s = ops / FP32_FLOPS, nbytes / HBM_BYTES_S
    return {"ops": ops, "bytes": nbytes, "ops_s": ops_s, "bytes_s": bytes_s,
            "least_s": max(ops_s, bytes_s), "bound": "ops" if ops_s >= bytes_s else "bytes"}
