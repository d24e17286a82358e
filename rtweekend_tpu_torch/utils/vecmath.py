"""Batched 3-vector math over trailing-axis-3 tensors (reference
src/rtw/vec.zig:8-109), the same formulas as rtweekend_tpu.utils.vecmath."""

from __future__ import annotations

import torch

NEAR_ZERO_EPS = 1e-8  # reference src/rtw/vec.zig:99


def dot(u, v):
    return torch.sum(u * v, dim=-1)


def norm_squared(v):
    return torch.sum(v * v, dim=-1)


def norm(v):
    return torch.sqrt(norm_squared(v))


def cross(u, v):
    return torch.linalg.cross(u, v, dim=-1)


def normalized(v):
    """Unit vector, v unchanged where ||v|| == 0 (vec.zig:33-40). The
    guard sits on the rsqrt input so no lane ever sees inf."""
    ns = norm_squared(v)[..., None]
    zero = ns == 0.0
    inv = torch.rsqrt(torch.where(zero, torch.ones_like(ns), ns))
    return torch.where(zero, v, v * inv)


def near_zero(v):
    return torch.all(torch.abs(v) < NEAR_ZERO_EPS, dim=-1)


def reflect(v, n):
    return v - 2.0 * dot(v, n)[..., None] * n


def refract(uv, n, etai_over_etat):
    """Snell refraction (material.zig:116-121); the sqrt argument is clamped
    away from 0 as in the JAX package, since every lane evaluates it."""
    cos_theta = torch.clamp(dot(-uv, n), max=1.0)
    r_out_perp = etai_over_etat[..., None] * (uv + cos_theta[..., None] * n)
    par_sq = torch.clamp(torch.abs(1.0 - norm_squared(r_out_perp)), min=1e-12)
    return r_out_perp - torch.sqrt(par_sq)[..., None] * n
