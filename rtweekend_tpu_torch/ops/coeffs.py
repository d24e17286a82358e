"""Coefficient formulation of the closest-hit test (rtweekend_tpu.ops.coeffs).

Every candidate hit quantity for a (ray, primitive) pair is a dot
product of a 17-wide per-ray FEATURE vector with a per-primitive
COEFFICIENT row, followed by a short epilogue. This module builds the
rows and the epilogues; the plain bounce version and the CUDA kernel
both consume them, so the two share the candidate-t math.

Sphere quadratic with the moving center c(t) = beta + t*alpha
(alpha = inv_dt*dc, beta = c0 - time0*alpha, hittable.zig:219-221):

    half_b = o.d - beta.d - t (alpha.d)
    c_coef = |o|^2 - 2 o.beta - 2t (o.alpha) + 2t (beta.alpha)
             + t^2 |alpha|^2 + (|beta|^2 - r^2)

Rect plane solve with the uv normalization folded in (hittable.zig:270-427):

    t = (k - o.wn - bn) / (d.wn),  valid iff u, v in [0, 1]
"""

from __future__ import annotations

import torch

# Feature vector layout.
(
    F_DX, F_DY, F_DZ,          # ray direction
    F_TDX, F_TDY, F_TDZ,       # time * direction
    F_OD,                      # o . d
    F_OX, F_OY, F_OZ,          # ray origin
    F_TOX, F_TOY, F_TOZ,       # time * origin
    F_T,                       # time
    F_TT,                      # time^2
    F_OO,                      # |o|^2
    F_ONE,                     # 1
) = range(17)
NF = 17

# Sentinel for "no hit".
BIG = 1e30
# Nearest accepted hit distance (reference src/main.zig:109).
T_MIN = 1e-3


def ray_features(o, d, time):
    """[N, NF] feature matrix for a flat ray batch."""
    o_d = torch.sum(o * d, dim=-1)
    o_o = torch.sum(o * o, dim=-1)
    t = time
    cols = [
        d[:, 0], d[:, 1], d[:, 2],
        t * d[:, 0], t * d[:, 1], t * d[:, 2],
        o_d,
        o[:, 0], o[:, 1], o[:, 2],
        t * o[:, 0], t * o[:, 1], t * o[:, 2],
        t, t * t, o_o,
        torch.ones_like(t),
    ]
    return torch.stack(cols, dim=-1)


def sphere_coeffs(scene):
    """(A_hb [S, NF], A_cc [S, NF]): feature . A_hb[i] is half_b and
    feature . A_cc[i] is c_coef for sphere i. Inactive spheres get
    all-zero rows (disc == 0 -> guaranteed miss)."""
    sp = scene.spheres
    alpha = sp.dc * sp.inv_dt[:, None]
    beta = sp.c0 - sp.time0[:, None] * alpha
    s = sp.c0.shape[0]
    hb = sp.c0.new_zeros((s, NF))
    hb[:, F_DX:F_DZ + 1] = -beta
    hb[:, F_TDX:F_TDZ + 1] = -alpha
    hb[:, F_OD] = 1.0
    cc = sp.c0.new_zeros((s, NF))
    cc[:, F_OX:F_OZ + 1] = -2.0 * beta
    cc[:, F_TOX:F_TOZ + 1] = -2.0 * alpha
    cc[:, F_T] = 2.0 * torch.sum(beta * alpha, dim=-1)
    cc[:, F_TT] = torch.sum(alpha * alpha, dim=-1)
    cc[:, F_OO] = 1.0
    cc[:, F_ONE] = torch.sum(beta * beta, dim=-1) - sp.radius * sp.radius
    act = sp.active[:, None]
    return torch.where(act, hb, 0.0), torch.where(act, cc, 0.0)


def _inv_spans(rc):
    # padding rects have degenerate bounds; guard the reciprocal
    da_span = rc.a1 - rc.a0
    db_span = rc.b1 - rc.b0
    inv_da = 1.0 / torch.where(da_span == 0.0, 1.0, da_span)
    inv_db = 1.0 / torch.where(db_span == 0.0, 1.0, db_span)
    return inv_da, inv_db


def rect_coeffs(scene):
    """Six [R, NF] blocks (kn, dn, ua, da, vb, db) such that for feature f:
    t = f.kn / f.dn, u = f.ua + t f.da, v = f.vb + t f.db. Inactive rects
    get all-zero rows (dn == 0 -> miss)."""
    rc = scene.rects
    r = rc.k.shape[0]
    inv_da, inv_db = _inv_spans(rc)

    def rows(w3, const):
        m = rc.wn.new_zeros((r, NF))
        m[:, F_OX:F_OZ + 1] = w3
        m[:, F_ONE] = const
        return m

    def drows(w3):
        m = rc.wn.new_zeros((r, NF))
        m[:, F_DX:F_DZ + 1] = w3
        return m

    kn = rows(-rc.wn, rc.k - rc.bn)
    dn = drows(rc.wn)
    ua = rows(rc.wa * inv_da[:, None], (rc.ba - rc.a0) * inv_da)
    da = drows(rc.wa * inv_da[:, None])
    vb = rows(rc.wb * inv_db[:, None], (rc.bb - rc.b0) * inv_db)
    db = drows(rc.wb * inv_db[:, None])
    act = rc.active[:, None]
    return tuple(torch.where(act, m, 0.0) for m in (kn, dn, ua, da, vb, db))


def quadratic_t(hb, cc, a, inv_a, t_min, big=BIG):
    """Nearest valid sphere root from (half_b, c_coef) candidates: the near
    root if >= t_min, else the far root, else miss (hittable.zig:104-116)."""
    disc = hb * hb - a * cc
    ok = disc > 0.0
    sq = torch.sqrt(torch.where(ok, disc, 1.0))
    root1 = -(hb + sq) * inv_a
    root2 = (sq - hb) * inv_a
    t12 = torch.where(root1 >= t_min, root1, root2)
    valid = ok & (t12 >= t_min)
    return torch.where(valid, t12, big)


def rect_t(kn, dn, ua, da, vb, db, t_min, big=BIG):
    """Valid rect hit t; bounds inclusive in the normalized frame
    (hittable.zig:283-286)."""
    dn_ok = dn != 0.0
    t = kn / torch.where(dn_ok, dn, 1.0)
    u = ua + t * da
    v = vb + t * db
    ok = dn_ok & (t >= t_min) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (v <= 1.0)
    return torch.where(ok, t, big)


def rect_uv_rows(scene):
    """Per-rect affine uv rows at the hit POINT: u = p.ua_w + ua_c,
    v = p.vb_w + vb_c."""
    rc = scene.rects
    inv_da, inv_db = _inv_spans(rc)
    ua_w = rc.wa * inv_da[:, None]
    ua_c = (rc.ba - rc.a0) * inv_da
    vb_w = rc.wb * inv_db[:, None]
    vb_c = (rc.bb - rc.b0) * inv_db
    return ua_w, ua_c, vb_w, vb_c
