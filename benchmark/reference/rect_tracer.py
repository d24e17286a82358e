"""A plain path tracer of spheres and axis-aligned rects under RotateY and
Translate instances, lit by DiffuseLight (the Cornell box), in float32.

One bounce of one ray: the closest primitive along the ray over every
real sphere (reference.tracer's coefficient form) and every real rect,
solved the textbook way. For each rect:

1. the ray is moved into the instance's frame, Translate first (origin
   minus offset, hittable.zig:478-489), then RotateY
   (x' = cos x - sin z, z' = sin x + cos z, hittable.zig:563-567);
2. the axis plane is solved, t = (k - o_axis) / d_axis, and the hit
   accepted if t >= t_min and the point's other two coordinates lie in
   the rect's bounds, inclusive (hittable.zig:270-427);
3. the fixed outward normal of the family (+z, +y, +x) is rotated back
   to world space (hittable.zig:584-590) and flipped against the ray
   (front_face, from the object-space ray).

Ties go to the lower index, spheres first, then rects in scene order. The
integrator is the reference's (main.zig:103-122): a miss adds
throughput * background; a DiffuseLight hit adds throughput * emit, on
either face, and ends the path; diffuse, metal and glass scatter with the
counter-RNG draws of (seed, pixel, sample, bounce) and the material maths
of reference.tracer. Only live rays are traced at each bounce.

`march="tf32"` rounds the operands of the plane solve and of the bounds
check (the ray in the instance's frame, k) to TF32, and the sphere march
as reference.tracer does: the reference computed one step below float32.

Departures from the reference ray tracer, all on purpose:
- no rect UV: the hit's (u, v) is not computed, since every texture here
  is solid or checker (which reads the hit point, not u and v);
- no BVH: every ray is tested against every primitive, brute force, as
  BASELINE config 4 says of intersection;
- the hit point is o + t d in world space; the reference maps the
  object-space point back through RotateY and Translate, the same point
  rounded otherwise;
- a ray parallel to a rect's plane (d_axis = 0) misses it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import tracer
from benchmark.reference.camera import BOUNCE_STREAM0, pcg4d, unit
from benchmark.reference.rect_scenes import AXES
from benchmark.reference.scenes import MAT_DIELECTRIC, MAT_LIGHT, MAT_METAL, TEX_CHECKER

T_MIN = tracer.T_MIN
BIG = tracer.BIG
_INTS = ("n_spheres", "n_rects")


def scene_tensors(arrays: dict, device) -> dict:
    """The scene's arrays (reference.rect_scenes.build) on `device`,
    float32, with each rect's RotateY cosine and sine and its axes."""
    out = {}
    for k, v in arrays.items():
        if k in _INTS:
            out[k] = int(v)
            continue
        t = torch.as_tensor(np.asarray(v), device=device)
        out[k] = t.to(torch.float32) if t.is_floating_point() else t
    th = np.radians(np.asarray(arrays["rot_y"], np.float64))
    out["cos"] = torch.as_tensor(np.cos(th), dtype=torch.float32, device=device)
    out["sin"] = torch.as_tensor(np.sin(th), dtype=torch.float32, device=device)
    axes = np.asarray([AXES[int(f)] for f in arrays["family"]], np.int64).reshape(-1, 3)
    out["axes"] = torch.as_tensor(axes, device=device)
    return out


def _to_object(sc: dict, o, d):
    """The rays [N, 3] in every rect's instance frame: (origins, dirs),
    each [N, R, 3]."""
    c, s = sc["cos"][None, :], sc["sin"][None, :]
    oo = o[:, None, :] - sc["offset"][None, :, :]
    ob = torch.stack([c * oo[..., 0] - s * oo[..., 2], oo[..., 1],
                      s * oo[..., 0] + c * oo[..., 2]], dim=-1)
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    db = torch.stack([c * dx - s * dz, dy.expand(-1, c.shape[1]), s * dx + c * dz], dim=-1)
    return ob, db


@torch.no_grad()
def rect_hits(sc: dict, o, d, march: str = "fp32"):
    """(t [N, R], object-space direction along each rect's normal [N, R]):
    t of each real rect's hit, BIG on a miss."""
    r = sc["n_rects"]
    ob, db = _to_object(sc, o, d)
    cols = torch.arange(r, device=o.device)

    def axis(x, k):
        return x[:, cols, sc["axes"][:, k]]

    on, dn = axis(ob, 0), axis(db, 0)
    oa, da, o_b, d_b = axis(ob, 1), axis(db, 1), axis(ob, 2), axis(db, 2)
    k = sc["k"][None, :]
    if march == "tf32":
        on, dn, oa, da, o_b, d_b = (tracer.tf32(x) for x in (on, dn, oa, da, o_b, d_b))
        k = tracer.tf32(k)
    t = (k - on) / dn
    a = oa + t * da
    b = o_b + t * d_b
    ok = ((dn != 0.0) & (t >= T_MIN) & (t < BIG) & (a >= sc["a0"]) & (a <= sc["a1"])
          & (b >= sc["b0"]) & (b <= sc["b1"]))
    return torch.where(ok, t, BIG), dn


def _world_normal(sc: dict, j):
    """The outward normal [n, 3] of rects j in world space: the family's
    axis, rotated back by RotateY (x = cos x' + sin z', z = -sin x' + cos z')."""
    n_obj = torch.nn.functional.one_hot(sc["axes"][j, 0], 3).to(torch.float32)
    c, s = sc["cos"][j], sc["sin"][j]
    return torch.stack([c * n_obj[:, 0] + s * n_obj[:, 2], n_obj[:, 1],
                        -s * n_obj[:, 0] + c * n_obj[:, 2]], dim=1)


def _scatter(sc: dict, b: int, pl, sl, seed: int, dev, d, pt, nrm, front, m):
    """reference.tracer's draws and material maths for hits on materials m
    at points pt with normals nrm facing the ray: (new directions,
    attenuation, material colour, is light, survives)."""
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
    col = sc["color"][tex]
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
    mdir = refl + sc["fuzz"][m][:, None] * (uvec * crad[:, None])
    m_alive = (refl * nrm).sum(1) > 0.0
    # ---- glass: Snell with Schlick's reflectance ----
    ior = sc["ior"][m]
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
    return ndir, att, col, is_l, (is_m & m_alive) | (~is_m & ~is_l)


@torch.no_grad()
def trace(sc: dict, o, d, tm, pid, sid, seed: int, background, max_depth: int, *,
          march: str = "fp32", counts: dict | None = None):
    """Radiance [N, 3] of rays (o, d, tm) keyed by pixel and sample ids
    under a flat background of 3 floats. counts, if a dict, gains the live
    ray-bounces and live misses."""
    dev = o.device
    seed = int(seed) & 0xFFFFFFFF
    ns, nr = sc["n_spheres"], sc["n_rects"]
    rows = tracer._rows(sc) if ns else None
    bg = torch.as_tensor(background, dtype=torch.float32, device=dev)
    n = o.shape[0]
    live = torch.arange(n, device=dev)
    thr = torch.ones((n, 3), device=dev)
    parts_ids, parts_rad = [], []
    for b in range(max_depth):
        if live.numel() == 0:
            break
        t_ = tm[live]
        # the closest sphere and the closest rect; a tie goes to the sphere
        js, ts = tracer.closest(rows, o, d, t_, march) if ns else (None, None)
        if nr:
            t_r, dn = rect_hits(sc, o, d, march)
            tr = t_r.min(dim=1).values
            iota = torch.arange(nr, device=dev)
            jr = torch.where(t_r == tr[:, None], iota, nr).min(dim=1).values
        if ns and nr:
            is_s = ts <= tr
            t_hit = torch.where(is_s, ts, tr)
        else:
            is_s = torch.full_like(live, bool(ns), dtype=torch.bool)
            t_hit = ts if ns else tr
        hit = t_hit < BIG * 0.5
        if counts is not None:
            counts["live_ray_bounces"] = counts.get("live_ray_bounces", 0) + live.numel()
            counts["live_misses"] = counts.get("live_misses", 0) + int((~hit).sum())
        miss = ~hit
        if bool(miss.any()):
            parts_ids.append(live[miss])
            parts_rad.append(thr[miss] * bg)
        keep = hit.nonzero().squeeze(1)
        live, o, d, thr, t_hit, t_, is_s = (x[keep] for x in (live, o, d, thr, t_hit, t_, is_s))
        pt = o + t_hit[:, None] * d
        # ---- outward normal, the face the ray meets, the material ----
        if nr:
            jr = jr[keep]
            out_n = _world_normal(sc, jr)
            front = dn[keep].gather(1, jr[:, None])[:, 0] < 0.0
            m = sc["rect_mat"][jr]
        if ns:
            js = torch.where(is_s, js[keep], 0)
            centre = sc["c0"][js] + ((t_ - sc["time0"][js]) * sc["inv_dt"][js])[:, None] \
                * sc["dc"][js]
            out_s = (pt - centre) * (1.0 / sc["radius"][js])[:, None]
            front_s = (d * out_s).sum(1) < 0.0
            if nr:
                out_n = torch.where(is_s[:, None], out_s, out_n)
                front = torch.where(is_s, front_s, front)
                m = torch.where(is_s, sc["mat_id"][js], m)
            else:
                out_n, front, m = out_s, front_s, sc["mat_id"][js]
        nrm = out_n * torch.where(front, 1.0, -1.0)[:, None]
        ndir, att, col, is_l, go = _scatter(sc, b, pid[live], sid[live], seed, dev, d, pt,
                                            nrm, front, m)
        if bool(is_l.any()):
            parts_ids.append(live[is_l])
            parts_rad.append(thr[is_l] * col[is_l])
        go = go.nonzero().squeeze(1)
        live, o, d, thr = live[go], pt[go], ndir[go], thr[go] * att[go]
    if not parts_ids:
        return torch.zeros((n, 3), device=dev)
    return torch.zeros((n, 3), device=dev).index_add(0, torch.cat(parts_ids),
                                                      torch.cat(parts_rad))
