"""Counter-based stateless sampling (PCG4D), bit-equal to rtweekend_tpu.

Every sample is a pure function of (seed, pixel_id, sample_id, stream):
the PCG4D integer hash (Jarzynski & Olano, JCGT 2020) maps a 4-word
counter to 4 uniform words. Reordering or compacting rays cannot change
a sample, which is what makes the compacted driver bit-equal to the
uncompacted one.

PyTorch has little uint32 arithmetic (none on the CPU for `*`, `>>` on
unsigned words), so words are carried in int64 holding values in
[0, 2^32): every add and multiply is masked back to 32 bits and `>>` is
then a logical shift. A product of two full words is split into 16-bit
halves so that no intermediate leaves the int64 range. The CUDA kernel
computes the same hash natively in uint32.
"""

from __future__ import annotations

import math

import torch

from rtweekend_tpu_torch.utils import vecmath

# Stream ids: camera raygen uses fixed high streams; bounce b uses
# streams BOUNCE_STREAM0 + 2*b and +2*b+1 (same ids as the JAX package).
STREAM_CAMERA0 = 0xC0FFEE00
STREAM_CAMERA1 = 0xC0FFEE01
BOUNCE_STREAM0 = 0x10000

_MASK = 0xFFFFFFFF
_LCG_MUL = 1664525
_LCG_ADD = 1013904223


def _u32(x, device=None) -> torch.Tensor:
    """A uint32 word (or words) as int64 in [0, 2^32). int32 inputs are
    reinterpreted bit for bit (negative ids map above 2^31)."""
    if isinstance(x, int):
        return torch.tensor(x & _MASK, dtype=torch.int64, device=device)
    return torch.as_tensor(x, device=device).to(torch.int64) & _MASK


def _mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a * b) mod 2^32 for words in [0, 2^32), without int64 overflow."""
    al, ah = a & 0xFFFF, a >> 16
    bl, bh = b & 0xFFFF, b >> 16
    mid = (ah * bl + al * bh) & 0xFFFF
    return (al * bl + (mid << 16)) & _MASK


def _lcg(x: torch.Tensor) -> torch.Tensor:
    # the multiplier is < 2^21, so the product stays below 2^53
    return (x * _LCG_MUL + _LCG_ADD) & _MASK


def pcg4d(a, b, c, d, device=None):
    """PCG4D hash: 4 uint32 counters -> 4 uint32 random words (int64)."""
    x, y, z, w = (_lcg(_u32(v, device)) for v in (a, b, c, d))
    x = (x + _mul(y, w)) & _MASK
    y = (y + _mul(z, x)) & _MASK
    z = (z + _mul(x, y)) & _MASK
    w = (w + _mul(y, z)) & _MASK
    x = x ^ (x >> 16)
    y = y ^ (y >> 16)
    z = z ^ (z >> 16)
    w = w ^ (w >> 16)
    x = (x + _mul(y, w)) & _MASK
    y = (y + _mul(z, x)) & _MASK
    z = (z + _mul(x, y)) & _MASK
    w = (w + _mul(y, z)) & _MASK
    return x, y, z, w


def to_unit(bits: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """uint32 word -> [0, 1) float from its top 24 bits."""
    return (bits >> 8).to(dtype) * (2.0**-24)


def uniform4(seed, pixel_ids, sample_ids, stream, dtype=torch.float32):
    """Four U[0,1) draws per ray: [N, 4].

    seed and stream are Python ints (streams may exceed 2^31);
    pixel_ids/sample_ids are int32 or int64 tensors [N]."""
    dev = pixel_ids.device
    x, y, z, w = pcg4d(pixel_ids, sample_ids, stream, seed, device=dev)
    return torch.stack([to_unit(v, dtype) for v in (x, y, z, w)], dim=-1)


def gauss4_from_u4(u):
    """Box-Muller: 4 uniforms [..., 4] -> 4 independent standard normals.
    log(1-u) with 1-u in [2^-24, 1], so no lane is -inf."""
    two_pi = 2.0 * math.pi
    r0 = torch.sqrt(-2.0 * torch.log1p(-u[..., 0]))
    r1 = torch.sqrt(-2.0 * torch.log1p(-u[..., 2]))
    t0 = two_pi * u[..., 1]
    t1 = two_pi * u[..., 3]
    return torch.stack(
        [r0 * torch.cos(t0), r0 * torch.sin(t0), r1 * torch.cos(t1), r1 * torch.sin(t1)],
        dim=-1,
    )


def unit_vector(seed, pixel_ids, sample_ids, stream, dtype=torch.float32):
    """Uniform direction on the unit sphere from normalized gaussians
    (replaces the rejection-sampled randomUnitVector, rand.zig:38-40)."""
    g = gauss4_from_u4(uniform4(seed, pixel_ids, sample_ids, stream, dtype))
    return vecmath.normalized(g[..., :3])


def cbrt(u):
    """Cube root of u >= 0. PyTorch has no cbrt: u ** (1/3) rounds 1/3 and
    then the power, so it can sit an ulp or two off jnp.cbrt
    (tests/test_torch_rng.py measures the gap)."""
    return u.pow(1.0 / 3.0)


def in_unit_sphere(seed, pixel_ids, sample_ids, stream, radius_u, dtype=torch.float32):
    """Uniform point in the unit ball: a gaussian direction scaled by the
    cube root of radius_u (volume element r^2 dr; rand.zig:22-28)."""
    d = unit_vector(seed, pixel_ids, sample_ids, stream, dtype)
    return d * cbrt(radius_u)[..., None]


def in_unit_disk_from_u(u1, u2):
    """Uniform point in the unit disk (z=0) from two uniforms (sqrt-polar;
    replaces the reference's rejection loop, rand.zig:30-36)."""
    r = torch.sqrt(u1)
    theta = (2.0 * math.pi) * u2
    return torch.stack(
        [r * torch.cos(theta), r * torch.sin(theta), torch.zeros_like(r)], dim=-1
    )
