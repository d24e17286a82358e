"""Closest-hit intersection of the eager integrator (rtweekend_tpu.ops.intersect).

Candidate t for every (ray, primitive) pair, masked to BIG where there is
no valid hit, then an argmin over primitives: the reference's
closest-so-far scan (hittable.zig:231-244) as one batched computation
with t_min = 0.001 (main.zig:109) and the nearest-root rule. The
candidate quantities are feature-vector x coefficient-row products
(ops/coeffs.py), one [N, NF] @ [NF, P] matmul per coefficient block, in
full fp32 (the package turns TF32 off) or float64; the epilogues are the
bounce kernel's.

Unlike the bounce kernel this path is differentiable end to end: the
winner's t, hit point, normal and uv carry gradients to the scene's
float leaves. The argmin's ties go to the lowest index, as jnp.argmin's.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from rtweekend_tpu_torch.models.scene import Scene
from rtweekend_tpu_torch.ops import coeffs
from rtweekend_tpu_torch.ops.coeffs import BIG, T_MIN
from rtweekend_tpu_torch.utils import vecmath


def gather(table, idx):
    """table[idx] for a float table [R] or [R, k] and indices idx [N], as
    an embedding lookup: the same values, but its backward is a sort-based
    segment sum, where indexing's backward walks each row's duplicates
    serially (every miss, and every ray on a rect, reads sphere row 0)."""
    if table.dim() == 1:
        return F.embedding(idx, table[:, None])[:, 0]
    return F.embedding(idx, table)


@dataclasses.dataclass
class Hit:
    t: torch.Tensor           # [N] (BIG where no hit)
    hit: torch.Tensor         # [N] bool
    p: torch.Tensor           # [N, 3]
    normal: torch.Tensor      # [N, 3] front-face-flipped
    front_face: torch.Tensor  # [N] bool
    u: torch.Tensor           # [N]
    v: torch.Tensor           # [N]
    mat_id: torch.Tensor      # [N] int32


def sphere_candidate_ts(scene: Scene, o, d, time, t_min):
    """Candidate hit t for every (ray, sphere): [N, S] (the quadratic of
    hittable.zig:96-116 through the shared coefficient rows)."""
    feats = coeffs.ray_features(o, d, time)
    a_hb, a_cc = coeffs.sphere_coeffs(scene)
    hb = feats @ a_hb.t()
    cc = feats @ a_cc.t()
    a = vecmath.norm_squared(d)[:, None]
    return coeffs.quadratic_t(hb, cc, a, 1.0 / a, t_min)


def rect_candidate_ts(scene: Scene, o, d, time, t_min):
    """Candidate hit t for every (ray, rect): [N, R] (the plane solve of
    hittable.zig:279, :332, :385 in each rect's object frame; inclusive
    bounds)."""
    feats = coeffs.ray_features(o, d, time)
    kn, dn, ua, da, vb, db = (feats @ m.t() for m in coeffs.rect_coeffs(scene))
    return coeffs.rect_t(kn, dn, ua, da, vb, db, t_min)


def closest(scene: Scene, o, d, time, t_min: float = T_MIN):
    """(idx [N] int64, t [N]): the closest primitive of every ray (o, d
    [N, 3], time [N]) over spheres then rects, and its t (BIG: no hit).
    torch.amin splits a tie's gradient evenly, as jnp.min does."""
    t_all = torch.cat([sphere_candidate_ts(scene, o, d, time, t_min),
                       rect_candidate_ts(scene, o, d, time, t_min)], dim=1)
    return torch.argmin(t_all, dim=1), torch.amin(t_all, dim=1)


def intersect(scene: Scene, o, d, time, t_min: float = T_MIN) -> Hit:
    """Closest hit across all primitives for a ray batch."""
    idx, t_best = closest(scene, o, d, time, t_min)
    return resolve_hit(scene, o, d, time, idx, t_best < BIG * 0.5, t_best)


def sphere_uv(outward):
    """getSphereUv (hittable.zig:145-150) of unit outward normals [N, 3]:
    (u, v) [N], with true atan2/acos. The acos input is clamped 1e-7 inside
    [-1, 1] and atan2 is guarded at the poles, where both have infinite
    gradients."""
    at_pole = (outward[:, 2].abs() + outward[:, 0].abs()) < 1e-12
    phi = torch.atan2(-torch.where(at_pole, 0.0, outward[:, 2]),
                      torch.where(at_pole, 1.0, outward[:, 0])) + math.pi
    theta = torch.acos(torch.clamp(-outward[:, 1], -1.0 + 1e-7, 1.0 - 1e-7))
    return phi / (2.0 * math.pi), theta / math.pi


def resolve_hit(scene: Scene, o, d, time, idx, hit, t_best) -> Hit:
    """Winner attributes for primitive `idx` per ray: hit point, front-face
    normal, uv and material id (Sphere.hit:118-127, rect uv
    hittable.zig:287-289)."""
    sp, rc = scene.spheres, scene.rects
    n_s = sp.radius.shape[0]
    t_eff = torch.where(hit, t_best, 1.0)   # keeps a miss's geometry finite
    p = o + t_eff[:, None] * d

    is_sphere = idx < n_s
    si = torch.where(is_sphere, idx, 0)
    ri = torch.where(is_sphere, 0, idx - n_s)

    s_t = (time - gather(sp.time0, si)) * gather(sp.inv_dt, si)
    center_w = gather(sp.c0, si) + s_t[:, None] * gather(sp.dc, si)
    outward_sph = (p - center_w) / gather(sp.radius, si)[:, None]
    u_sph, v_sph = sphere_uv(outward_sph)

    ua_w, ua_c, vb_w, vb_c = coeffs.rect_uv_rows(scene)
    u_rect = vecmath.dot(p, gather(ua_w, ri)) + gather(ua_c, ri)
    v_rect = vecmath.dot(p, gather(vb_w, ri)) + gather(vb_c, ri)

    outward = torch.where(is_sphere[:, None], outward_sph, gather(rc.normal, ri))
    front_face = vecmath.dot(outward, d) < 0.0
    normal = torch.where(front_face[:, None], outward, -outward)
    mat_id = torch.where(is_sphere, sp.mat_id[si], rc.mat_id[ri])
    return Hit(
        t=t_best, hit=hit, p=p, normal=normal, front_face=front_face,
        u=torch.where(is_sphere, u_sph, u_rect),
        v=torch.where(is_sphere, v_sph, v_rect),
        mat_id=torch.where(hit, mat_id, 0),
    )
