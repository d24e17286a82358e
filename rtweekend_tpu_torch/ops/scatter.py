"""Branchless material scatter (rtweekend_tpu.ops.scatter), shared by the
eager integrator and the differentiable replay (ops/replay.py).

All four material families (material.zig:22-38) are computed for every
lane and selected by type. Every draw is a counter hash of (seed, pixel,
sample, stream), with streams BOUNCE_STREAM0 + 2 * bounce and + 1, the
streams of the bounce kernel and of the JAX package.
"""

from __future__ import annotations

import dataclasses

import torch

from rtweekend_tpu_torch.models.scene import MAT_DIELECTRIC, MAT_LIGHT, MAT_METAL, Scene
from rtweekend_tpu_torch.ops.intersect import Hit, gather
from rtweekend_tpu_torch.ops.textures import TextureRows, shade, texture_rows
from rtweekend_tpu_torch.utils import rng as rng_mod
from rtweekend_tpu_torch.utils import vecmath


@dataclasses.dataclass
class Surface:
    """Material of each ray's hit, one row a ray: gathered from the scene's
    tables (surface_at) or sliced from the replay's packed winner rows."""
    mtype: torch.Tensor   # [N] int material type
    fuzz: torch.Tensor    # [N]
    ior: torch.Tensor     # [N]
    tex: TextureRows


def surface_at(scene: Scene, mat_id) -> Surface:
    mats = scene.materials
    mid = mat_id.long()
    return Surface(mtype=mats.mtype[mid], fuzz=gather(mats.fuzz, mid),
                   ior=gather(mats.ior, mid), tex=texture_rows(scene, mats.tex_id[mid]))


@dataclasses.dataclass
class Scatter:
    direction: torch.Tensor    # [N, 3] next-bounce direction
    attenuation: torch.Tensor  # [N, 3]
    emitted: torch.Tensor      # [N, 3]
    alive: torch.Tensor        # [N] bool: False = absorbed or a light


def scatter(scene: Scene, seed: int, pixel_ids, sample_ids, bounce_idx: int, d_in,
            hit: Hit, surface: Surface | None = None) -> Scatter:
    """One scatter event per ray at bounce `bounce_idx`; `surface` defaults
    to the materials of hit.mat_id."""
    if surface is None:
        surface = surface_at(scene, hit.mat_id)
    dtype = d_in.dtype

    stream_a = rng_mod.BOUNCE_STREAM0 + 2 * int(bounce_idx)
    u_b = rng_mod.uniform4(seed, pixel_ids, sample_ids, stream_a + 1, dtype)
    # the diffuse direction and the metal fuzz point share stream A's
    # gaussians: the two branches never apply to the same ray
    unit_vec = rng_mod.unit_vector(seed, pixel_ids, sample_ids, stream_a, dtype)
    sphere_pt = unit_vec * rng_mod.cbrt(u_b[:, 0])[:, None]
    u_choice = u_b[:, 1]

    # albedo of diffuse and metal, emission of lights
    tex_val = shade(scene, surface.tex, hit.u, hit.v, hit.p)

    # diffuse (material.zig:41-53): normal + random unit vector
    diff_dir = hit.normal + unit_vec
    diff_dir = torch.where(vecmath.near_zero(diff_dir)[:, None], hit.normal, diff_dir)

    # metal (material.zig:55-66): fuzzed mirror, absorbed below the surface
    unit_in = vecmath.normalized(d_in)
    reflected = vecmath.reflect(unit_in, hit.normal)
    metal_dir = reflected + surface.fuzz[:, None] * sphere_pt
    metal_alive = vecmath.dot(reflected, hit.normal) > 0.0

    # dielectric (material.zig:68-92): Snell with Schlick reflection
    ior = surface.ior
    ratio = torch.where(hit.front_face, 1.0 / ior, ior)
    # minimum/maximum split a tie's gradient as jnp.minimum/maximum do
    u_dot_n = vecmath.dot(-unit_in, hit.normal)
    one = torch.ones_like(u_dot_n)
    cos_theta = torch.minimum(u_dot_n, one)
    sin_theta = torch.sqrt(torch.maximum(1.0 - cos_theta * cos_theta, 1e-20 * one))
    can_refract = ratio * sin_theta <= 1.0
    r0 = (1.0 - ratio) / (1.0 + ratio)
    r0 = r0 * r0
    # (1 - cos)^5 by squaring, as jnp's integer power multiplies
    one_c = 1.0 - cos_theta
    one_c2 = one_c * one_c
    reflectance = r0 + (1.0 - r0) * (one_c2 * one_c2 * one_c)
    do_refract = can_refract & (reflectance < u_choice)
    refr_dir = vecmath.refract(unit_in, hit.normal, ratio)
    diel_dir = torch.where(do_refract[:, None], refr_dir, reflected)

    is_metal = surface.mtype == MAT_METAL
    is_diel = surface.mtype == MAT_DIELECTRIC
    is_light = surface.mtype == MAT_LIGHT
    direction = torch.where(is_metal[:, None], metal_dir, diff_dir)
    direction = torch.where(is_diel[:, None], diel_dir, direction)
    attenuation = torch.where(is_diel[:, None], 1.0, tex_val)
    # only lights emit (material.zig:31-38), and they end the path
    emitted = torch.where(is_light[:, None], tex_val, 0.0)
    alive = torch.where(is_metal, metal_alive, True) & ~is_light
    return Scatter(direction=direction, attenuation=attenuation, emitted=emitted,
                   alive=alive)
