"""A plain path tracer of the book-cover scenes (spheres, solid and checker
textures, diffuse, metal and glass, flat or gradient sky), in float32.

One bounce of one ray: the closest sphere along the ray, found by the
coefficient form of the sphere quadratic (a 17-term dot product of ray
features with a per-sphere row, summed term by term); the material's
scatter with the counter-RNG draws of (seed, pixel, sample, bounce); the
sky on a miss. Only live rays are traced at each bounce.

`march="tf32"` rounds the dot product's operands to TF32 (10 mantissa
bits, to nearest), the precision of the card's tensor cores: the
reference computed one step below float32, which the benchmark's
comparison has to reject.

With `params` given (sphere centres c0 and radii, texture colours, metal
fuzz, glass ior as tensors that require grad), the radiance is
differentiable with respect to them under autograd by the detached
estimator: each ray's path (which sphere it hits, which branch of each
material it takes) is decided without gradient, and along that fixed path
the winner's hit distance is the textbook root of |o + t d - c|^2 = r^2.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.camera import BOUNCE_STREAM0, pcg4d, unit
from benchmark.reference.scenes import MAT_DIELECTRIC, MAT_LIGHT, MAT_METAL, TEX_CHECKER

T_MIN = 1e-3
BIG = 1e30
PARAMS = ("c0", "radius", "color", "fuzz", "ior")


def scene_tensors(arrays: dict, device) -> dict:
    """The scene's arrays (reference.scenes.build) on `device`, float32."""
    out = {}
    for k, v in arrays.items():
        if k == "n_spheres":
            out[k] = int(v)
            continue
        t = torch.as_tensor(v, device=device)
        out[k] = t.to(torch.float32) if t.is_floating_point() else t
    return out


def tf32(x):
    """x rounded to TF32: the float32 mantissa kept to 10 bits, to nearest."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _rows(sc: dict):
    """Per real sphere, the coefficient rows of half_b and c (17 features:
    d, t d, o.d, o, t o, t, t^2, o.o, 1) of the moving-centre quadratic
    c(t) = beta + t alpha."""
    n = sc["n_spheres"]
    alpha = sc["dc"][:n] * sc["inv_dt"][:n, None]
    beta = sc["c0"][:n] - sc["time0"][:n, None] * alpha
    z = torch.zeros(n, device=alpha.device)
    one = torch.ones(n, device=alpha.device)
    hb = torch.stack([-beta[:, 0], -beta[:, 1], -beta[:, 2], -alpha[:, 0], -alpha[:, 1],
                      -alpha[:, 2], one, z, z, z, z, z, z, z, z, z, z], dim=1)
    cc = torch.stack([z, z, z, z, z, z, z, -2 * beta[:, 0], -2 * beta[:, 1], -2 * beta[:, 2],
                      -2 * alpha[:, 0], -2 * alpha[:, 1], -2 * alpha[:, 2],
                      2 * (beta * alpha).sum(1), (alpha * alpha).sum(1), one,
                      (beta * beta).sum(1) - sc["radius"][:n] ** 2], dim=1)
    return hb, cc


def _dot_rows(feats, rows, march: str):
    if march == "tf32":
        feats, rows = tf32(feats), tf32(rows)
    out = feats[:, :1] * rows[:, 0][None, :]
    for k in range(1, feats.shape[1]):
        out = out + feats[:, k:k + 1] * rows[:, k][None, :]
    return out


def _roots(hb, cc, a, t_min=T_MIN):
    """The nearest root >= t_min of t^2 a + 2 t hb + cc, else BIG."""
    disc = hb * hb - a * cc
    ok = disc > 0.0
    sq = torch.sqrt(torch.where(ok, disc, 1.0))
    inv_a = 1.0 / a
    r1 = -(hb + sq) * inv_a
    r2 = (sq - hb) * inv_a
    t = torch.where(r1 >= t_min, r1, r2)
    return torch.where(ok & (t >= t_min), t, BIG)


@torch.no_grad()
def closest(rows, o, d, tm, march: str):
    """(index of the closest sphere, its t) per ray; ties go to the lower
    index; t = BIG on a miss."""
    hb_rows, cc_rows = rows
    feats = torch.stack([d[:, 0], d[:, 1], d[:, 2], tm * d[:, 0], tm * d[:, 1], tm * d[:, 2],
                         (o * d).sum(1), o[:, 0], o[:, 1], o[:, 2], tm * o[:, 0],
                         tm * o[:, 1], tm * o[:, 2], tm, tm * tm, (o * o).sum(1),
                         torch.ones_like(tm)], dim=1)
    a = (d * d).sum(1)[:, None]
    t = _roots(_dot_rows(feats, hb_rows, march), _dot_rows(feats, cc_rows, march), a)
    best = t.min(dim=1).values
    iota = torch.arange(t.shape[1], device=t.device)
    idx = torch.where(t == best[:, None], iota, t.shape[1]).min(dim=1).values
    return idx, best


def trace(sc: dict, o, d, tm, pid, sid, seed: int, background, max_depth: int, *,
          march: str = "fp32", params: dict | None = None, counts: dict | None = None,
          record: list | None = None, winners: list | None = None):
    """Radiance [N, 3] of rays (o, d, tm) keyed by pixel and sample ids.
    background: 3 floats (flat sky) or a (bottom, top) pair (gradient
    sky). counts, if a dict, gains the live ray-bounces and live misses.
    record, if a list, gains each bounce's winners [N] (the sphere hit,
    -1 for a miss or a dead ray); `winners` so recorded replays those
    paths instead of searching for the closest sphere: with `params`
    requiring grad, that is the detached estimator's gradient."""
    dev = o.device
    seed = int(seed) & 0xFFFFFFFF
    p = {k: sc[k] for k in PARAMS} if params is None else params
    geo = dict(sc, c0=p["c0"], radius=p["radius"])
    rows = _rows({k: (v.detach() if torch.is_tensor(v) else v) for k, v in geo.items()})
    bg = torch.as_tensor(background, dtype=torch.float32, device=dev)
    n = o.shape[0]
    live = torch.arange(n, device=dev)
    thr = torch.ones((n, 3), device=dev)
    parts_ids, parts_rad = [], []
    # along a path fixed without gradient, the winner's t is the textbook
    # root, as differentiable as the centre and radius it comes from
    replay_t = params is not None and torch.is_grad_enabled()
    for b in range(max_depth):
        if live.numel() == 0:
            break
        t_ = tm[live]
        if winners is None:
            j, t_hit = closest(rows, o, d, t_, march)
            j = torch.where(t_hit < BIG * 0.5, j, -1)
        else:
            j = winners[b][live].long()
            t_hit = torch.where(j >= 0, 0.0, BIG)
        if record is not None:
            record.append(torch.full((n,), -1, dtype=torch.int32, device=dev).index_put(
                (live,), j.to(torch.int32)))
        jj = torch.where(j >= 0, j, 0)
        centre = geo["c0"][jj] + ((t_ - sc["time0"][jj]) * sc["inv_dt"][jj])[:, None] * sc["dc"][jj]
        if replay_t:
            oc = o - centre
            r = geo["radius"][jj]
            t_hit = _roots((oc * d).sum(1), (oc * oc).sum(1) - r * r, (d * d).sum(1))
            t_hit = torch.where((j >= 0) & (t_hit < BIG * 0.5), t_hit, BIG)
        hit = t_hit < BIG * 0.5
        if counts is not None:
            counts["live_ray_bounces"] = counts.get("live_ray_bounces", 0) + live.numel()
            counts["live_misses"] = counts.get("live_misses", 0) + int((~hit).sum())
        # ---- sky on a miss ----
        miss = ~hit
        if bool(miss.any()):
            dm = d[miss]
            if bg.dim() == 1:
                sky = bg.expand(dm.shape)
            else:
                dsq = (dm * dm).sum(1)
                tsky = 0.5 * (dm[:, 1] * torch.rsqrt(torch.where(dsq == 0, 1.0, dsq)) + 1.0)
                sky = (1.0 - tsky)[:, None] * bg[0] + tsky[:, None] * bg[1]
            parts_ids.append(live[miss])
            parts_rad.append(thr[miss] * sky)
        # ---- the winner's hit point and normal ----
        keep = hit.nonzero().squeeze(1)
        live, j, o, d, thr = live[keep], jj[keep], o[keep], d[keep], thr[keep]
        t_hit, centre = t_hit[keep], centre[keep]
        m = sc["mat_id"][j]
        pt = o + t_hit[:, None] * d
        out_n = (pt - centre) * (1.0 / geo["radius"][j])[:, None]
        front = (d * out_n).sum(1) < 0.0
        nrm = out_n * torch.where(front, 1.0, -1.0)[:, None]
        # ---- draws: two PCG4D words sets per bounce ----
        pl, sl = pid[live], sid[live]
        stream = BOUNCE_STREAM0 + 2 * b
        ua = [unit(x) for x in pcg4d(pl, sl, stream, seed, dev)]
        ub = [unit(x) for x in pcg4d(pl, sl, stream + 1, seed, dev)[:2]]
        g_r0 = torch.sqrt(-2.0 * torch.log1p(-ua[0]))
        g_r1 = torch.sqrt(-2.0 * torch.log1p(-ua[2]))
        g = torch.stack([g_r0 * torch.cos(2 * math.pi * ua[1]),
                         g_r0 * torch.sin(2 * math.pi * ua[1]),
                         g_r1 * torch.cos(2 * math.pi * ua[3])], dim=1)
        gsq = (g * g).sum(1)
        gz = torch.sqrt(gsq) == 0.0
        uvec = torch.where(gz[:, None], g, g * torch.rsqrt(torch.where(gz, 1.0, gsq))[:, None])
        crad = torch.exp(torch.log(torch.clamp(ub[0], min=1e-30)) * (1.0 / 3.0))
        # ---- texture ----
        tex = sc["tex_id"][m]
        col = p["color"][tex]
        sines = torch.sin(10.0 * pt[:, 0]) * torch.sin(10.0 * pt[:, 1]) * torch.sin(10.0 * pt[:, 2])
        odd = (sc["ttype"][tex] == TEX_CHECKER) & (sines < 0.0)
        col = torch.where(odd[:, None], sc["color2"][tex], col)
        # ---- diffuse: normal + unit vector ----
        ddir = nrm + uvec
        deg = (ddir.abs() < 1e-8).all(1)
        ddir = torch.where(deg[:, None], nrm, ddir)
        # ---- metal: mirror + fuzz * point in the unit ball ----
        dsq = (d * d).sum(1)
        u_in = d * torch.rsqrt(torch.where(dsq == 0.0, 1.0, dsq))[:, None]
        u_n = (u_in * nrm).sum(1)
        refl = u_in - 2.0 * u_n[:, None] * nrm
        mdir = refl + p["fuzz"][m][:, None] * (uvec * crad[:, None])
        m_alive = (refl * nrm).sum(1) > 0.0
        # ---- glass: Snell with Schlick's reflectance ----
        ior = p["ior"][m]
        ratio = torch.where(front, 1.0 / ior, ior)
        cos_t = torch.clamp(-u_n, max=1.0)
        sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=1e-20))
        r0 = ((1.0 - ratio) / (1.0 + ratio)) ** 2
        oc5 = (1.0 - cos_t) ** 2
        oc5 = oc5 * oc5 * (1.0 - cos_t)
        refr = (ratio * sin_t <= 1.0) & (r0 + (1.0 - r0) * oc5 < ub[1])
        perp = ratio[:, None] * (u_in + cos_t[:, None] * nrm)
        par = -torch.sqrt(torch.clamp((1.0 - (perp * perp).sum(1)).abs(), min=1e-12))
        gdir = torch.where(refr[:, None], perp + par[:, None] * nrm, refl)
        # ---- pick by material ----
        mt = sc["mtype"][m]
        is_m, is_g, is_l = mt == MAT_METAL, mt == MAT_DIELECTRIC, mt == MAT_LIGHT
        ndir = torch.where(is_g[:, None], gdir, torch.where(is_m[:, None], mdir, ddir))
        att = torch.where(is_g[:, None], 1.0, col)
        if bool(is_l.any()):
            parts_ids.append(live[is_l])
            parts_rad.append(thr[is_l] * col[is_l])
        go = ((is_m & m_alive) | (~is_m & ~is_l)).nonzero().squeeze(1)
        live, o, d, thr = live[go], pt[go], ndir[go], thr[go] * att[go]
    if not parts_ids:
        return torch.zeros((n, 3), device=dev)
    return torch.zeros((n, 3), device=dev).index_add(0, torch.cat(parts_ids),
                                                      torch.cat(parts_rad))
