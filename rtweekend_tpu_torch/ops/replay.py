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

The winner's t and normal are the JAX replay's formulas, with every guard
that keeps a gradient finite through an unselected `where` branch
(0 * inf = NaN): the safe radius of rects, the dn != 0 guard and the
t_eff of misses. The texture, the scatter and the accumulation are the
eager integrator's (ops/textures.py, ops/scatter.py,
integrator.accumulate), applied to the winner's packed rows.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from rtweekend_tpu_torch.models.scene import Scene
from rtweekend_tpu_torch.ops.coeffs import BIG, T_MIN, quadratic_t
from rtweekend_tpu_torch.ops.integrator import accumulate
from rtweekend_tpu_torch.ops.intersect import Hit, sphere_uv
from rtweekend_tpu_torch.ops.scatter import Surface, scatter
from rtweekend_tpu_torch.ops.textures import TextureRows

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
    front = torch.sum(outward * d, dim=-1) < 0.0
    normal = outward * torch.where(front, 1.0, -1.0)[:, None]

    # ---- uv, read by the image texture only ----
    u = v = None
    if scene.has_image:
        u_sph, v_sph = sphere_uv(outward)
        u = torch.where(is_s, u_sph, torch.sum(p * af[:, _UWX:_UWZ + 1], dim=-1) + af[:, _UC])
        v = torch.where(is_s, v_sph, torch.sum(p * af[:, _VWX:_VWZ + 1], dim=-1) + af[:, _VC])

    # ---- scatter and accumulate: the eager integrator's, on the winner's rows ----
    hit_rec = Hit(t=t_best, hit=hit, p=p, normal=normal, front_face=front, u=u, v=v,
                  mat_id=None)
    surface = Surface(
        mtype=ai[:, _MTYPE], fuzz=af[:, _FUZZ], ior=af[:, _IOR],
        tex=TextureRows(ttype=ai[:, _TTYPE], color=af[:, _CR:_CB + 1],
                        color2=af[:, _C2R:_C2B + 1], scale=af[:, _TSCALE],
                        image_id=ai[:, _IMG]))
    sc = scatter(scene, seed, pixel_ids, sample_ids, bounce_idx, d, hit_rec, surface)
    return accumulate(background, o, d, hit_rec, sc, throughput, radiance, alive)


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
