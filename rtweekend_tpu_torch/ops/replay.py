"""Differentiable path replay through packed winner-attribute gathers
(rtweekend_tpu.ops.replay).

The bounce kernel decides each path: per bounce it emits the index of
the closest-hit primitive (`trace_paths(..., return_winners=True)`).
Given those indices, every other step of a path is a smooth function of
the scene, the rays and the counter RNG. `trace_paths_replay_fast`
re-traces exactly those paths with plain tensor ops — per bounce one
gather of the winner's row from a packed [P, 34] float table and a
[P, 3] int table — so PyTorch autograd differentiates the radiance with
respect to the scene's float leaves, the rays and the background. The
estimator is detached sampling (see rtweekend_tpu_torch/grad.py): the
discrete decisions carry no gradient.

The formulas are the JAX replay's, formula for formula, including every
guard that keeps a gradient finite through an unselected `where` branch
(0 * inf = NaN): the safe radius of rects, the dn != 0 guard and the
t_eff of misses, sqrt and rsqrt of clamped arguments. Minimum and
maximum are torch.minimum/maximum, whose gradient splits at a tie as
JAX's does.
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from rtweekend_tpu_torch.models.scene import (
    MAT_DIELECTRIC,
    MAT_LIGHT,
    MAT_METAL,
    TEX_CHECKER,
    TEX_IMAGE,
    TEX_NOISE,
    Scene,
)
from rtweekend_tpu_torch.ops.coeffs import BIG, T_MIN, quadratic_t
from rtweekend_tpu_torch.ops.integrator import sky_color
from rtweekend_tpu_torch.utils import perlin as perlin_mod
from rtweekend_tpu_torch.utils import rng as rng_mod

# Float-table columns [P, 34], spheres then rects (replay.py:53-68):
(
    _C0X, _C0Y, _C0Z,        # sphere center c0 (rects: 0)
    _DCX, _DCY, _DCZ,        # sphere center delta
    _T0, _IDT,               # motion time0 / 1/dt
    _RAD,                    # radius (rects: 0, guarded)
    _WNX, _WNY, _WNZ,        # rect plane row w_n (spheres: 0)
    _BN, _K,                 # rect plane bias / offset
    _NX, _NY, _NZ,           # rect world outward normal
    _UWX, _UWY, _UWZ, _UC,   # rect u(p) affine row
    _VWX, _VWY, _VWZ, _VC,   # rect v(p) affine row
    _FUZZ, _IOR,
    _CR, _CG, _CB,           # texture color / checker even
    _C2R, _C2G, _C2B,        # checker odd
    _TSCALE,                 # noise scale
) = range(34)
_MTYPE, _TTYPE, _IMG = range(3)

_NEAR_ZERO = 1e-8


def replay_tables(scene: Scene):
    """(attr_f [P, 34] float, attr_i [P, 3] int32) in global primitive
    order, materials and textures denormalized onto primitives. Built
    from the scene's float leaves with tensor ops on every call, so
    gradients reach the leaves."""
    sp, rc = scene.spheres, scene.rects
    mats, tex = scene.materials, scene.textures
    dt = sp.c0.dtype
    zs = sp.c0.new_zeros((sp.radius.shape[0],))
    zr = sp.c0.new_zeros((rc.k.shape[0],))

    # rect uv affine rows (ops/coeffs.rect_uv_rows)
    da = rc.a1 - rc.a0
    db = rc.b1 - rc.b0
    inv_da = 1.0 / torch.where(da == 0.0, 1.0, da)
    inv_db = 1.0 / torch.where(db == 0.0, 1.0, db)

    def mat_cols(mat_id):
        mid = mat_id.long()
        tid = mats.tex_id[mid].long()
        return (
            [mats.fuzz[mid], mats.ior[mid],
             tex.color[tid, 0], tex.color[tid, 1], tex.color[tid, 2],
             tex.color2[tid, 0], tex.color2[tid, 1], tex.color2[tid, 2],
             tex.scale[tid]],
            [mats.mtype[mid], tex.ttype[tid], tex.image_id[tid]],
        )

    s_mf, s_mi = mat_cols(sp.mat_id)
    r_mf, r_mi = mat_cols(rc.mat_id)

    def cat(a, b):
        return torch.cat([a.to(dt), b.to(dt)])

    cols = [
        cat(sp.c0[:, 0], zr), cat(sp.c0[:, 1], zr), cat(sp.c0[:, 2], zr),
        cat(sp.dc[:, 0], zr), cat(sp.dc[:, 1], zr), cat(sp.dc[:, 2], zr),
        cat(sp.time0, zr), cat(sp.inv_dt, torch.ones_like(zr)),
        cat(sp.radius, zr),
        cat(zs, rc.wn[:, 0]), cat(zs, rc.wn[:, 1]), cat(zs, rc.wn[:, 2]),
        cat(zs, rc.bn), cat(zs, rc.k),
        cat(zs, rc.normal[:, 0]), cat(zs, rc.normal[:, 1]), cat(zs, rc.normal[:, 2]),
        cat(zs, rc.wa[:, 0] * inv_da), cat(zs, rc.wa[:, 1] * inv_da),
        cat(zs, rc.wa[:, 2] * inv_da), cat(zs, (rc.ba - rc.a0) * inv_da),
        cat(zs, rc.wb[:, 0] * inv_db), cat(zs, rc.wb[:, 1] * inv_db),
        cat(zs, rc.wb[:, 2] * inv_db), cat(zs, (rc.bb - rc.b0) * inv_db),
        *[cat(a, b) for a, b in zip(s_mf, r_mf)],
    ]
    attr_f = torch.stack(cols, dim=1)
    attr_i = torch.stack(
        [torch.cat([a.to(torch.int32), b.to(torch.int32)]) for a, b in zip(s_mi, r_mi)],
        dim=1,
    )
    return attr_f, attr_i


def _bounce(scene: Scene, attr_f, attr_i, times, pixel_ids, sample_ids, seed: int,
            background, t_min: float, bounce_idx: int,
            o, d, throughput, radiance, alive, winner):
    """One replayed bounce (replay.py:164-336); returns the new carry."""
    n_s = scene.spheres.radius.shape[0]
    dtype = o.dtype

    kernel_hit = winner >= 0
    idx = torch.where(kernel_hit, winner, 0).long()
    # one packed gather of the winner's row. As an embedding lookup its
    # backward is a sort-based segment sum; attr_f[idx]'s backward
    # (indexing_backward_kernel) walks each row's duplicates serially,
    # and every miss and dead ray shares row 0: 0.54 s a call at 811,008
    # rays on an H100, 95% of a train step (chip_smoke.py profile_train)
    af = torch.nn.functional.embedding(idx, attr_f)   # [N, 34]
    ai = attr_i[idx]                                  # [N, 3], no gradient
    is_s = idx < n_s

    # ---- winner hit t (hittable.zig:96-116 / :279) ----
    s_t = (times - af[:, _T0]) * af[:, _IDT]
    center = af[:, _C0X:_C0Z + 1] + s_t[:, None] * af[:, _DCX:_DCZ + 1]
    oc = o - center
    a = torch.sum(d * d, dim=-1)
    half_b = torch.sum(oc * d, dim=-1)
    rad_safe = torch.where(is_s, af[:, _RAD], 1.0)
    c = torch.sum(oc * oc, dim=-1) - rad_safe * rad_safe
    t_sph = quadratic_t(half_b, c, a, 1.0 / a, t_min)

    wn = af[:, _WNX:_WNZ + 1]
    dn = torch.sum(d * wn, dim=-1)
    dn_ok = dn != 0.0
    t_rect = (af[:, _K] - torch.sum(o * wn, dim=-1) - af[:, _BN]) / torch.where(dn_ok, dn, 1.0)
    t_rect = torch.where(dn_ok & (t_rect >= t_min), t_rect, BIG)

    t_best = torch.where(is_s, t_sph, t_rect)
    t_best = torch.where(kernel_hit, t_best, BIG)
    hit = kernel_hit & (t_best < BIG * 0.5)
    t_eff = torch.where(hit, t_best, 1.0)
    p = o + t_eff[:, None] * d

    # ---- normal (front-face flipped) ----
    outward_sph = (p - center) / rad_safe[:, None]
    outward = torch.where(is_s[:, None], outward_sph, af[:, _NX:_NZ + 1])
    d_dot_n = torch.sum(outward * d, dim=-1)
    front = d_dot_n < 0.0
    sgn = torch.where(front, 1.0, -1.0)
    normal = outward * sgn[:, None]

    # ---- RNG: the same streams as the bounce kernel ----
    stream_a = rng_mod.BOUNCE_STREAM0 + 2 * bounce_idx
    u_b = rng_mod.uniform4(seed, pixel_ids, sample_ids, stream_a + 1, dtype)
    unit_vec = rng_mod.unit_vector(seed, pixel_ids, sample_ids, stream_a, dtype)
    sphere_pt = unit_vec * rng_mod.cbrt(u_b[:, 0])[:, None]
    u_choice = u_b[:, 1]

    # ---- texture at the hit (texture.zig:46-145) ----
    ttype = ai[:, _TTYPE]
    tex_val = af[:, _CR:_CB + 1]
    if scene.has_checker:
        sines = torch.sin(10.0 * p[:, 0]) * torch.sin(10.0 * p[:, 1]) * torch.sin(10.0 * p[:, 2])
        checker = torch.where((sines < 0.0)[:, None], af[:, _C2R:_C2B + 1], tex_val)
        tex_val = torch.where((ttype == TEX_CHECKER)[:, None], checker, tex_val)
    if scene.has_noise:
        turbv = perlin_mod.turb(scene.perlin_grad, scene.perlin_px, scene.perlin_py,
                                scene.perlin_pz, p, depth=7)
        gray = 0.5 * (1.0 + torch.sin(af[:, _TSCALE] * p[:, 2] + 10.0 * turbv))
        tex_val = torch.where((ttype == TEX_NOISE)[:, None], gray[:, None], tex_val)
    if scene.has_image:
        # sphere uv (getSphereUv, hittable.zig:145-150) / rect affine uv
        at_pole = (torch.abs(outward[:, 2]) + torch.abs(outward[:, 0])) < 1e-12
        phi = torch.atan2(
            -torch.where(at_pole, 0.0, outward[:, 2]),
            torch.where(at_pole, 1.0, outward[:, 0]),
        ) + math.pi
        theta = torch.acos(torch.clamp(-outward[:, 1], -1.0 + 1e-7, 1.0 - 1e-7))
        u_rect = torch.sum(p * af[:, _UWX:_UWZ + 1], dim=-1) + af[:, _UC]
        v_rect = torch.sum(p * af[:, _VWX:_VWZ + 1], dim=-1) + af[:, _VC]
        u = torch.where(is_s, phi / (2.0 * math.pi), u_rect)
        v = torch.where(is_s, theta / math.pi, v_rect)
        img_id = ai[:, _IMG].long()
        w_i, h_i = scene.image_w[img_id], scene.image_h[img_id]
        uu = torch.clamp(u, 0.0, 1.0)
        vv = 1.0 - torch.clamp(v, 0.0, 1.0)
        i_ = torch.minimum((uu * w_i.to(dtype)).to(torch.int32), w_i - 1).long()
        j_ = torch.minimum((vv * h_i.to(dtype)).to(torch.int32), h_i - 1).long()
        texel = scene.images[img_id, j_, i_].to(dtype)
        rgb = texel[:, :3] / 255.0
        ocean = torch.tensor([0.0, 0.0, 1.0], dtype=dtype, device=o.device)
        img_col = torch.where((texel[:, 3] == 0.0)[:, None], ocean[None, :], rgb)
        tex_val = torch.where((ttype == TEX_IMAGE)[:, None], img_col, tex_val)

    # ---- scatter (material.zig:41-110) ----
    diff_dir = normal + unit_vec
    deg = torch.sum(torch.abs(diff_dir) < _NEAR_ZERO, dim=-1) == 3
    diff_dir = torch.where(deg[:, None], normal, diff_dir)

    d_sq = torch.sum(d * d, dim=-1)
    unit_in = d * torch.rsqrt(torch.where(d_sq == 0.0, 1.0, d_sq))[:, None]
    u_dot_n = torch.sum(unit_in * normal, dim=-1)
    reflected = unit_in - 2.0 * u_dot_n[:, None] * normal
    metal_dir = reflected + af[:, _FUZZ][:, None] * sphere_pt
    metal_alive = torch.sum(reflected * normal, dim=-1) > 0.0

    one = torch.ones((), dtype=dtype, device=o.device)
    ior = af[:, _IOR]
    ratio = torch.where(front, 1.0 / ior, ior)
    cos_theta = torch.minimum(-u_dot_n, one)
    sin_theta = torch.sqrt(torch.maximum(1.0 - cos_theta * cos_theta, 1e-20 * one))
    can_refract = ratio * sin_theta <= 1.0
    r0 = (1.0 - ratio) / (1.0 + ratio)
    r0 = r0 * r0
    one_c = 1.0 - cos_theta
    one_c2 = one_c * one_c
    reflectance = r0 + (1.0 - r0) * (one_c2 * one_c2 * one_c)   # (1-cos)^5
    do_refract = can_refract & (reflectance < u_choice)
    perp = ratio[:, None] * (unit_in + cos_theta[:, None] * normal)
    perp_sq = torch.sum(perp * perp, dim=-1)
    par = -torch.sqrt(torch.maximum(torch.abs(1.0 - perp_sq), 1e-12 * one))
    refr_dir = perp + par[:, None] * normal
    diel_dir = torch.where(do_refract[:, None], refr_dir, reflected)

    mtype = ai[:, _MTYPE]
    is_metal = mtype == MAT_METAL
    is_diel = mtype == MAT_DIELECTRIC
    is_light = mtype == MAT_LIGHT
    direction = torch.where(is_metal[:, None], metal_dir, diff_dir)
    direction = torch.where(is_diel[:, None], diel_dir, direction)
    attenuation = torch.where(is_diel[:, None], torch.ones_like(tex_val), tex_val)
    emitted = torch.where(is_light[:, None], tex_val, torch.zeros_like(tex_val))
    sc_alive = torch.where(is_metal, metal_alive, torch.ones_like(is_metal)) & ~is_light

    # ---- accumulate (main.zig:110-121 + gradient sky) ----
    hit_live = alive & hit
    miss_live = alive & ~hit
    radiance = radiance + torch.where(hit_live[:, None], throughput * emitted, 0.0)
    radiance = radiance + torch.where(
        miss_live[:, None], throughput * sky_color(background, d), 0.0)
    new_alive = hit_live & sc_alive
    throughput = torch.where(new_alive[:, None], throughput * attenuation, throughput)
    o = torch.where(new_alive[:, None], p, o)
    d = torch.where(new_alive[:, None], direction, d)
    return o, d, throughput, radiance, new_alive


def trace_paths_replay_fast(scene: Scene, origins, dirs, times, pixel_ids, sample_ids,
                            seed: int, background, winners, *, t_min: float = T_MIN,
                            remat: bool = True):
    """Replay the paths that `winners` [max_depth, N] int32 (-1 = miss)
    decided. Returns radiance [N, 3], differentiable with respect to the
    scene's float leaves, the rays and the background (3 floats, or the
    (bottom, top) gradient sky [2, 3]).

    remat=True checkpoints every bounce (torch.utils.checkpoint): the
    backward pass recomputes a bounce from its carry instead of keeping
    its ~120 intermediates, so memory holds max_depth carries of
    ~52 bytes a ray. The RNG is a counter hash, so there is no RNG state
    to preserve across the recomputation."""
    seed = int(seed) & 0xFFFFFFFF
    background = torch.as_tensor(background, dtype=origins.dtype, device=origins.device)
    attr_f, attr_i = replay_tables(scene)
    consts = (scene, attr_f, attr_i, times, pixel_ids, sample_ids, seed, background, t_min)
    carry = (origins, dirs, torch.ones_like(origins), torch.zeros_like(origins),
             torch.ones(origins.shape[0], dtype=torch.bool, device=origins.device))
    for b in range(winners.shape[0]):
        if remat:
            carry = checkpoint(_bounce, *consts, b, *carry, winners[b],
                               use_reentrant=False, preserve_rng_state=False)
        else:
            carry = _bounce(*consts, b, *carry, winners[b])
    return carry[3]
