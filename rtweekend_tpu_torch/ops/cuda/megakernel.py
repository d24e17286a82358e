"""The bounce megakernel: tables, plain PyTorch version, CUDA wrapper and
the compacted driver.

Port of rtweekend_tpu/ops/pallas/megakernel.py. The TPU kernel
(`_make_kernel`, launched by `_trace_segment`) becomes the hand-written
CUDA kernel in `csrc/megakernel.cu`, reached through `trace_segment`.
Beside it, `trace_segment_plain` computes the same function with plain
tensor ops, following the TPU kernel's `bounce_body` op for op without
its (8, 128) tiles; `trace_segment` uses it for CPU tensors only.

Ray state is one [m, 14] float32 buffer, one row per ray (columns in
STATE_FIELDS order; the int32 fields pid, sid and ray_id ride bit-cast).
Compaction is then a single row gather, and the kernel reads and writes
56 contiguous bytes per ray. `ray_state` makes a render batch's state:
on the card in one launch of `raygen_kernel` (csrc/megakernel.cu), which
the host never waits on; elsewhere from the camera's PyTorch ops.

The compacted driver (`trace_paths_compact`) traces a few bounces per
launch and gathers the survivors into a smaller buffer between launches;
each launch adds its finished rays' radiance into the batch total at their
ray ids as it writes them out (`accum`), so no scatter follows it.
Buffer sizes come from a static per-bounce capacity schedule, so nothing
is read back to the host: the alive count and the overflow flag stay on
the device, and a capacity overflow raises the flag instead of dropping
rays silently. Compaction is exact (RNG streams are keyed by pixel,
sample and bounce, never by buffer position, and a ray adds radiance at
most once), so compacted output is bit-equal to the uncompacted output.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import numpy as np
import torch

from rtweekend_tpu_torch.models.scene import (
    MAT_DIELECTRIC,
    MAT_LIGHT,
    MAT_METAL,
    TEX_CHECKER,
    TEX_IMAGE,
    TEX_NOISE,
    Scene,
)
from rtweekend_tpu_torch.ops import coeffs
from rtweekend_tpu_torch.ops.camera import Camera, batch_rays
from rtweekend_tpu_torch.ops.coeffs import BIG, NF, T_MIN
from rtweekend_tpu_torch.utils import rng as rng_mod

TILE = 1024  # capacity granule, as the TPU kernel's (8, 128) tile
_NEAR_ZERO = 1e-8

# Attribute-table rows (rtweekend_tpu megakernel.py:158-175). Float rows:
(
    _AF_C0X, _AF_C0Y, _AF_C0Z,          # sphere center c0 (rects: 0)
    _AF_DCX, _AF_DCY, _AF_DCZ,          # sphere center delta
    _AF_T0, _AF_IDT,                    # motion time0 / 1/dt
    _AF_INVR,                           # 1 / radius
    _AF_NX, _AF_NY, _AF_NZ,             # rect world normal (spheres: 0)
    _AF_FUZZ, _AF_IOR,
    _AF_CR, _AF_CG, _AF_CB,             # texture color / checker even
    _AF_C2R, _AF_C2G, _AF_C2B,          # checker odd
    _AF_TSCALE,                         # noise scale
    _AF_UWX, _AF_UWY, _AF_UWZ, _AF_UC,  # rect u(p) affine row
    _AF_VWX, _AF_VWY, _AF_VWZ, _AF_VC,  # rect v(p) affine row
) = range(29)
# Int rows:
_AI_MTYPE, _AI_TTYPE, _AI_IMGW, _AI_IMGH, _AI_IMGBASE = range(5)

# Ray-state columns; the kernel (csrc/megakernel.cu) uses the same order.
STATE_FIELDS = (
    "ox", "oy", "oz", "dx", "dy", "dz", "tm", "pid", "sid",
    "tr", "tg", "tb", "al", "ray_id",
)
(S_OX, S_OY, S_OZ, S_DX, S_DY, S_DZ, S_TM, S_PID, S_SID,
 S_TR, S_TG, S_TB, S_AL, S_RID) = range(len(STATE_FIELDS))

# Shared memory one block may use on Hopper, less the kernel's mbarrier; the
# kernel stages the coefficient rows there as 20 floats each.
_SMEM_LIMIT = 232448 - 8
_ROW_BYTES = 80
# the next-ray counter may pass m by one ray for every lane group
_MAX_RAYS = 2**31 - 2**20


@dataclasses.dataclass
class Tables:
    """The scene packed for the kernel (rtweekend_tpu `_pack_scene`):

    - coef [2S+6R, 128] f32: [hb(S); cc(S); kn(R); dn(R); ua(R); da(R);
      vb(R); db(R)], NF=17 feature columns zero-padded to 128;
    - attr_f [29, C*128] f32 / attr_i [5, C*128] i32: winner attributes
      in primitive order (spheres then rects), materials and textures
      denormalized onto primitives;
    - perm/grad [8, 128]: the Perlin tables as half-rows; flattened,
      [0:256] is the x table, [256:512] y, [512:768] z;
    - images [C', 128] i32: the packed RGBA texel atlas (r | g<<8 |
      b<<16 | a<<24), read at image_base + row * width + column;
    - s_live / r_live: the spheres and rects the kernel scans, up to the
      last active one of each; the rows of the inactive primitives after
      them are zero and never win, so the scan skips them (the plain
      version scans every row).
    """

    coef: torch.Tensor
    attr_f: torch.Tensor
    attr_i: torch.Tensor
    perm: torch.Tensor
    grad: torch.Tensor
    images: torch.Tensor
    s_pad: int
    r_pad: int
    s_live: int
    r_live: int
    has_noise: bool
    has_image: bool
    has_motion: bool


def pack_scene(scene: Scene) -> Tables:
    sp, rc = scene.spheres, scene.rects
    if sp.c0.dtype != torch.float32:
        raise TypeError(f"the bounce kernel is float32 only; got a {sp.c0.dtype} scene "
                        "(float64 renders run on the eager integrator)")
    mats, tex = scene.materials, scene.textures
    s_pad = sp.radius.shape[0]
    r_pad = rc.k.shape[0]
    p = s_pad + r_pad
    pc = -(-p // 128) * 128

    a_hb, a_cc = coeffs.sphere_coeffs(scene)
    rect6 = coeffs.rect_coeffs(scene)
    coef = torch.cat([a_hb, a_cc, *rect6], dim=0).to(torch.float32)
    coef = torch.nn.functional.pad(coef, (0, 128 - NF))

    def cat(s_vals, r_vals, dtype=torch.float32):
        v = torch.cat([s_vals.to(dtype), r_vals.to(dtype)])
        return torch.nn.functional.pad(v, (0, pc - p))

    zs = sp.radius.new_zeros((s_pad,))
    zr = rc.k.new_zeros((r_pad,))
    # padding spheres never win (all-zero coef rows), but keep 1/r finite
    inv_r = torch.where(
        sp.active & (sp.radius != 0.0),
        1.0 / torch.where(sp.radius == 0.0, 1.0, sp.radius),
        0.0,
    )
    ua_w, ua_c, vb_w, vb_c = coeffs.rect_uv_rows(scene)

    def mat_rows(mat_id):
        mid = mat_id.long()
        tid = mats.tex_id[mid].long()
        img = tex.image_id[tid].long()
        return (
            [mats.fuzz[mid], mats.ior[mid],
             tex.color[tid, 0], tex.color[tid, 1], tex.color[tid, 2],
             tex.color2[tid, 0], tex.color2[tid, 1], tex.color2[tid, 2],
             tex.scale[tid]],
            [mats.mtype[mid], tex.ttype[tid], scene.image_w[img],
             scene.image_h[img], scene.image_base[img]],
        )

    s_mf, s_mi = mat_rows(sp.mat_id)
    r_mf, r_mi = mat_rows(rc.mat_id)
    attr_f = torch.stack([
        cat(sp.c0[:, 0], zr), cat(sp.c0[:, 1], zr), cat(sp.c0[:, 2], zr),
        cat(sp.dc[:, 0], zr), cat(sp.dc[:, 1], zr), cat(sp.dc[:, 2], zr),
        cat(sp.time0, zr), cat(sp.inv_dt, torch.ones_like(zr)),
        cat(inv_r, zr),
        cat(zs, rc.normal[:, 0]), cat(zs, rc.normal[:, 1]), cat(zs, rc.normal[:, 2]),
        *[cat(a, b) for a, b in zip(s_mf, r_mf)],
        cat(zs, ua_w[:, 0]), cat(zs, ua_w[:, 1]), cat(zs, ua_w[:, 2]), cat(zs, ua_c),
        cat(zs, vb_w[:, 0]), cat(zs, vb_w[:, 1]), cat(zs, vb_w[:, 2]), cat(zs, vb_c),
    ])
    attr_i = torch.stack([cat(a, b, torch.int32) for a, b in zip(s_mi, r_mi)])

    zi = torch.zeros(128, dtype=torch.int32, device=coef.device)
    perm = torch.stack([
        scene.perlin_px[:128], scene.perlin_px[128:],
        scene.perlin_py[:128], scene.perlin_py[128:],
        scene.perlin_pz[:128], scene.perlin_pz[128:], zi, zi,
    ]).to(torch.int32)
    g = scene.perlin_grad.to(torch.float32)
    zf = torch.zeros(128, dtype=torch.float32, device=coef.device)
    grad = torch.stack([
        g[:128, 0], g[128:, 0], g[:128, 1], g[128:, 1],
        g[:128, 2], g[128:, 2], zf, zf,
    ])
    # one device-to-host read: where the active primitives end
    act = torch.cat([sp.active, rc.active]).cpu()
    s_live = int(act[:s_pad].nonzero().max()) + 1 if bool(act[:s_pad].any()) else 0
    r_live = int(act[s_pad:].nonzero().max()) + 1 if bool(act[s_pad:].any()) else 0
    return Tables(
        coef=coef.contiguous(), attr_f=attr_f.contiguous(),
        attr_i=attr_i.contiguous(), perm=perm, grad=grad,
        images=scene.images_packed, s_pad=int(s_pad), r_pad=int(r_pad),
        s_live=s_live, r_live=r_live,
        has_noise=bool(scene.has_noise), has_image=bool(scene.has_image),
        has_motion=bool(scene.has_motion),
    )


def sky_floats(background):
    """(six floats, has_sky) for the kernel from a host background: 3
    floats are the flat sky (padded with zeros), a (bottom, top) pair
    [2, 3] selects the gradient-sky variant (megakernel.py:1001)."""
    bg = np.asarray(background, dtype=np.float32)
    if bg.shape == (3,):
        return (*bg.tolist(), 0.0, 0.0, 0.0), False
    if bg.shape == (2, 3):
        return tuple(bg.reshape(-1).tolist()), True
    raise ValueError(
        f"background must be 3 floats or a (bottom, top) pair, got {background!r}")


def init_state(origins, dirs, times, pixel_ids, sample_ids) -> torch.Tensor:
    """[m, 14] state for N rays, m = N rounded up to a TILE multiple; the
    padding rows are dead (rtweekend_tpu `_init_state`)."""
    n = origins.shape[0]
    m = _tiles(n)
    dev = origins.device
    st = torch.zeros((m, len(STATE_FIELDS)), dtype=torch.float32, device=dev)
    st[:n, S_OX:S_OZ + 1] = origins
    st[:n, S_DX:S_DZ + 1] = dirs
    st[n:, S_DZ] = 1.0
    st[:n, S_TM] = times
    st[:n, S_PID] = pixel_ids.to(torch.int32).view(torch.float32)
    st[:n, S_SID] = sample_ids.to(torch.int32).view(torch.float32)
    st[:, S_TR:S_TB + 1] = 1.0
    st[:n, S_AL] = 1.0
    st[:, S_RID] = torch.arange(m, dtype=torch.int32, device=dev).view(torch.float32)
    return st


def state_rays(state, n: int):
    """The first n rays of a state as init_state's arguments (origins,
    dirs, times, pixel_ids, sample_ids): column views, no copy."""
    return (state[:n, S_OX:S_OZ + 1], state[:n, S_DX:S_DZ + 1], state[:n, S_TM],
            _int_col(state, S_PID)[:n], _int_col(state, S_SID)[:n])


def camera_floats(camera: Camera) -> tuple:
    """The 21 camera values raygen_kernel takes, as host floats: origin,
    horizontal, vertical, lower_left, u, v, lens_radius, time0, time1.
    Reading them from the card is a sync: a caller that makes many batches
    reads them once."""
    c = camera
    parts = (c.origin, c.horizontal, c.vertical, c.lower_left, c.u, c.v,
             c.lens_radius.reshape(1), c.time0.reshape(1), c.time1.reshape(1))
    return tuple(torch.cat(parts).to(torch.float32).cpu().tolist())


def ray_state(camera: Camera, seed: int, sample_start: int, *, width: int, height: int,
              n_samples: int, pixels=None, host_camera=None,
              kernel: str = "auto") -> torch.Tensor:
    """A render batch's [m, 14] initial state, init_state(*batch_rays(...)):
    row r < n = (p1 - p0) * n_samples is sample sample_start + r %
    n_samples of pixel p0 + r // n_samples, pixels = (p0, p1) (default:
    the whole image); rows from n to m, n rounded up to a TILE multiple,
    are dead.

    kernel as in segment_fn: "auto" and "cuda" take raygen_kernel
    (csrc/megakernel.cu) on the card, one launch, no sync, bit-equal to
    those PyTorch ops on the card; it is float32 only, so a camera of
    another dtype on the card raises. The CPU and "torch" (the plain
    version) take the ops themselves. host_camera is
    camera_floats(camera), which a caller making many batches reads once;
    None reads it here. LAUNCHES["raygen_launches"] counts the kernel's
    launches."""
    dev = camera.origin.device
    # segment_fn checks the choice: "cuda" off the card raises
    if segment_fn(kernel, dev) is trace_segment_plain or dev.type != "cuda":
        return init_state(*batch_rays(camera, seed, sample_start, width=width, height=height,
                                      n_samples=n_samples, pixels=pixels))
    if camera.origin.dtype != torch.float32:
        raise ValueError(f"raygen_kernel is float32 only, got a {camera.origin.dtype} camera")
    p0, p1 = (0, width * height) if pixels is None else pixels
    n = (p1 - p0) * n_samples
    m = _tiles(n)
    if m >= _MAX_RAYS:
        raise ValueError("too many rays for one batch")
    if host_camera is None:
        host_camera = camera_floats(camera)
    from rtweekend_tpu_torch.ops.cuda import build

    lib, _ = build.load()
    state = torch.empty((m, len(STATE_FIELDS)), dtype=torch.float32, device=dev)
    # PyTorch divides a CUDA tensor by a host float as a multiply by the
    # float32 reciprocal, computed on the host in float32
    inv_w, inv_h = (float(np.float32(1.0) / np.float32(k - 1.0)) for k in (width, height))
    rc = lib.rtw_raygen(state.data_ptr(), n, m, p0, sample_start, n_samples, width,
                        inv_w, inv_h, int(seed) & 0xFFFFFFFF,
                        (ctypes.c_float * len(host_camera))(*host_camera),
                        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        msg = lib.rtw_error_string(rc).decode()
        raise RuntimeError(f"ray generation kernel launch failed: CUDA error {rc} ({msg})")
    LAUNCHES["raygen_launches"] += 1
    return state


def _int_col(state, k):
    return state[:, k].view(torch.int32)


def _march(feats, coef_t):
    """feats [m, NF] . coef_t [NF, rows], summed over the features in
    column order — the order of the CUDA kernel's multiply-add chain.
    A BLAS matmul sums in an unspecified blocked order; on final_scene
    (1024 rays, depth 8) that put 0.46% of lanes off the JAX kernel by
    more than 1e-3, against 0.36% for this order and a bar of 0.5%."""
    out = feats[:, :1] * coef_t[:1]
    for k in range(1, feats.shape[1]):
        out = out + feats[:, k:k + 1] * coef_t[k:k + 1]
    return out


def _perlin_noise(perm, grad, qx, qy, qz):
    """Perlin noise at points (qx, qy, qz) in the TPU kernel's operation
    order (megakernel.py:482-516): the gradient dot as cx*wx + cy*wy +
    cz*wz, the corner weight selecting s or 1 - s. perm/grad are the flat
    packed tables (x at [0:256], y at [256:512], z at [512:768]).
    utils/perlin.noise, which the replay differentiates, sums the dot
    with torch.sum and stays separate."""
    fx, fy, fz = torch.floor(qx), torch.floor(qy), torch.floor(qz)
    ux, uy, uz = qx - fx, qy - fy, qz - fz
    ix0, iy0, iz0 = fx.to(torch.int32), fy.to(torch.int32), fz.to(torch.int32)
    sx = ux * ux * (3.0 - 2.0 * ux)
    sy = uy * uy * (3.0 - 2.0 * uy)
    sz = uz * uz * (3.0 - 2.0 * uz)
    accum = torch.zeros_like(qx)
    for di in range(2):
        for dj in range(2):
            for dk in range(2):
                ix = ((ix0 + di) & 255).long()
                iy = ((iy0 + dj) & 255).long()
                iz = ((iz0 + dk) & 255).long()
                gi = (perm[ix] ^ perm[256 + iy] ^ perm[512 + iz]).long()
                cx, cy, cz = grad[gi], grad[256 + gi], grad[512 + gi]
                wx, wy, wz = ux - di, uy - dj, uz - dk
                w = ((sx if di else 1.0 - sx) * (sy if dj else 1.0 - sy)
                     * (sz if dk else 1.0 - sz))
                accum = accum + w * (cx * wx + cy * wy + cz * wz)
    return accum


def perlin_turb(perm, grad, qx, qy, qz, depth: int = 7):
    """|sum over `depth` octaves of 2^-k noise(2^k q)| in the TPU
    kernel's order (megakernel.py:518-525)."""
    accum = torch.zeros_like(qx)
    weight = 1.0
    for _ in range(depth):
        accum = accum + weight * _perlin_noise(perm, grad, qx, qy, qz)
        weight *= 0.5
        qx, qy, qz = qx * 2.0, qy * 2.0, qz * 2.0
    return torch.abs(accum)


def _atan2(y, x):
    """atan2 as the TPU kernel computes it (megakernel.py:348-370): octant
    reduction to t in [0, 1], a second reduction above tan(pi/8) and the
    Cephes atanf polynomial. torch.atan2 differs by ~1e-7 rad, enough to
    move a nearest texel at its boundary."""
    ax, ay = torch.abs(x), torch.abs(y)
    swap = ay > ax
    num = torch.where(swap, ax, ay)
    den = torch.clamp(torch.where(swap, ay, ax), min=1e-30)
    t = num / den
    med = t > 0.4142135623730950
    t = torch.where(med, (t - 1.0) / (t + 1.0), t)
    z = t * t
    p = (
        ((8.05374449538e-2 * z - 1.38776856032e-1) * z + 1.99777106478e-1) * z
        - 3.33329491539e-1
    ) * z * t + t
    p = torch.where(med, 0.25 * math.pi + p, p)
    p = torch.where(swap, 0.5 * math.pi - p, p)
    p = torch.where(x < 0.0, math.pi - p, p)
    return torch.where(y < 0.0, -p, p)


def _acos(c):
    """acos via _atan2(sqrt(1 - c^2), c); the caller clamps |c| < 1
    (megakernel.py:372-375). 1 - c^2 is rounded once, as the fused
    multiply-add the CUDA kernel uses (XLA fuses it too): near the poles
    the two roundings of an unfused form move the small angle by tens of
    ulps. The float64 product and difference are exact for |c| >= 1/8;
    below, a double-rounding tie is the only way to differ."""
    c64 = c.to(torch.float64)
    return _atan2(torch.sqrt(torch.clamp((1.0 - c64 * c64).to(c.dtype), min=0.0)), c)


def _image_rgb(tables: Tables, j, is_s, onx, ony, onz, px, py, pz):
    """The image texture's color at hits on primitives j
    (megakernel.py:700-779): sphere UV from the pre-flip outward normal
    with the pole guard, rect UV from the affine attribute rows, the
    nearest texel, alpha 0 -> (0, 0, 1). Call it only for live hits on
    an image texture: elsewhere the texel index is meaningless."""
    af, ai = tables.attr_f, tables.attr_i
    at_pole = (torch.abs(onz) + torch.abs(onx)) < 1e-12
    phi = _atan2(-torch.where(at_pole, 0.0, onz), torch.where(at_pole, 1.0, onx)) + math.pi
    theta = _acos(torch.clamp(-ony, -1.0 + 1e-7, 1.0 - 1e-7))
    u_rect = px * af[_AF_UWX, j] + py * af[_AF_UWY, j] + pz * af[_AF_UWZ, j] + af[_AF_UC, j]
    v_rect = px * af[_AF_VWX, j] + py * af[_AF_VWY, j] + pz * af[_AF_VWZ, j] + af[_AF_VC, j]
    uu = torch.where(is_s, phi * (0.5 / math.pi), u_rect)
    vv = torch.where(is_s, theta * (1.0 / math.pi), v_rect)
    iw, ih, ibase = ai[_AI_IMGW, j], ai[_AI_IMGH, j], ai[_AI_IMGBASE, j]
    uc = torch.clamp(uu, 0.0, 1.0)
    vc = 1.0 - torch.clamp(vv, 0.0, 1.0)
    ti = torch.minimum((uc * iw.to(torch.float32)).to(torch.int32), iw - 1)
    tj = torch.minimum((vc * ih.to(torch.float32)).to(torch.int32), ih - 1)
    packed = tables.images.reshape(-1)[(ibase + tj * iw + ti).long()]
    inv = 1.0 / 255.0
    zero_a = ((packed >> 24) & 255) == 0
    pr = torch.where(zero_a, 0.0, (packed & 255).to(torch.float32) * inv)
    pg = torch.where(zero_a, 0.0, ((packed >> 8) & 255).to(torch.float32) * inv)
    pb = torch.where(zero_a, 1.0, ((packed >> 16) & 255).to(torch.float32) * inv)
    return pr, pg, pb


def trace_segment_plain(tables: Tables, state, seed: int, background, b0: int,
                        n_bounces: int, t_min: float = T_MIN, *,
                        want_winners: bool = False, accum=None):
    """n_bounces bounces from global bounce b0 for every row of `state`,
    with plain tensor ops: the TPU kernel's bounce_body
    (megakernel.py:588-893), op for op, over flat [m] ray vectors.
    Returns (radiance delta [3, m], new state [m, 14]); dead rows pass
    through untouched and add nothing. want_winners adds winners
    [n_bounces, m] int32: the closest-hit primitive index of each bounce
    (spheres first, then s_pad + rect), -1 on a miss and wherever the ray
    is dead (the TPU kernel leaves those entries unspecified).
    background: 3 floats (flat sky) or a (bottom, top) pair (gradient
    sky). accum, a float32 [3, cols] buffer: each row alive at entry adds
    its radiance into accum[:, ray_id] instead (a row dead at entry adds
    nothing), and the radiance delta returned is None; the rows' ray ids
    must lie below cols, the live rows' distinct (trace_paths_compact's
    buffers)."""
    (bg_r, bg_g, bg_b, bg_r1, bg_g1, bg_b1), has_sky = sky_floats(background)
    s, r = tables.s_pad, tables.r_pad
    n_prims = s + r
    coef_t = tables.coef[:, :NF].t()
    af, ai = tables.attr_f, tables.attr_i
    perm, grad = tables.perm.reshape(-1), tables.grad.reshape(-1)
    dev = state.device

    ox, oy, oz = state[:, S_OX], state[:, S_OY], state[:, S_OZ]
    dx, dy, dz = state[:, S_DX], state[:, S_DY], state[:, S_DZ]
    time = state[:, S_TM]
    tr, tg, tb = state[:, S_TR], state[:, S_TG], state[:, S_TB]
    pid, sid = _int_col(state, S_PID), _int_col(state, S_SID)
    alive = state[:, S_AL] > 0.5
    al_out = state[:, S_AL]
    zero = torch.zeros_like(ox)
    rr, rg, rb = zero, zero, zero
    iota = torch.arange(n_prims, device=dev)
    winners = []

    for b in range(n_bounces):
        # ---- closest hit (megakernel.py:535-586) ----
        o_d = ox * dx + oy * dy + oz * dz
        o_o = ox * ox + oy * oy + oz * oz
        a = dx * dx + dy * dy + dz * dz
        inv_a = 1.0 / a
        feats = torch.stack([
            dx, dy, dz, time * dx, time * dy, time * dz, o_d,
            ox, oy, oz, time * ox, time * oy, time * oz,
            time, time * time, o_o, torch.ones_like(ox),
        ], dim=1)
        out = _march(feats, coef_t)                        # [m, 2S+6R]
        t_sph = coeffs.quadratic_t(
            out[:, :s], out[:, s:2 * s], a[:, None], inv_a[:, None], t_min
        )
        o2 = 2 * s
        t_rect = coeffs.rect_t(*(out[:, o2 + k * r:o2 + (k + 1) * r] for k in range(6)),
                               t_min)
        t_all = torch.cat([t_sph, t_rect], dim=1)          # [m, P]
        t_best = t_all.min(dim=1).values
        idx = torch.where(t_all == t_best[:, None], iota, n_prims).min(dim=1).values
        hit = t_best < BIG * 0.5
        if want_winners:
            winners.append(torch.where(alive & hit, idx, -1).to(torch.int32))
        t_eff = torch.where(hit, t_best, 1.0)
        px = ox + t_eff * dx
        py = oy + t_eff * dy
        pz = oz + t_eff * dz

        # ---- winner attributes (megakernel.py:601-631) ----
        j = torch.where(hit, idx, 0)
        is_s = j < s
        gf = lambda row: af[row, j]  # noqa: E731
        cx, cy, cz = gf(_AF_C0X), gf(_AF_C0Y), gf(_AF_C0Z)
        if tables.has_motion:
            s_t = (time - gf(_AF_T0)) * gf(_AF_IDT)
            cx = cx + s_t * gf(_AF_DCX)
            cy = cy + s_t * gf(_AF_DCY)
            cz = cz + s_t * gf(_AF_DCZ)
        inv_r = gf(_AF_INVR)
        fuzz, ior = gf(_AF_FUZZ), gf(_AF_IOR)
        cr, cg, cb = gf(_AF_CR), gf(_AF_CG), gf(_AF_CB)
        c2r, c2g, c2b = gf(_AF_C2R), gf(_AF_C2G), gf(_AF_C2B)
        mtype, ttype = ai[_AI_MTYPE, j], ai[_AI_TTYPE, j]

        onx = torch.where(is_s, (px - cx) * inv_r, gf(_AF_NX))
        ony = torch.where(is_s, (py - cy) * inv_r, gf(_AF_NY))
        onz = torch.where(is_s, (pz - cz) * inv_r, gf(_AF_NZ))
        d_dot_n = dx * onx + dy * ony + dz * onz
        front = d_dot_n < 0.0
        sgn = torch.where(front, 1.0, -1.0)
        nx, ny, nz = onx * sgn, ony * sgn, onz * sgn

        # ---- RNG (megakernel.py:645-665) ----
        stream_a = rng_mod.BOUNCE_STREAM0 + 2 * (b0 + b)
        x, y, z, w = rng_mod.pcg4d(pid, sid, stream_a, seed, device=dev)
        ua0, ua1, ua2, ua3 = (rng_mod.to_unit(v) for v in (x, y, z, w))
        x, y, _, _ = rng_mod.pcg4d(pid, sid, stream_a + 1, seed, device=dev)
        ub0, ub1 = rng_mod.to_unit(x), rng_mod.to_unit(y)
        two_pi = 2.0 * math.pi
        g_r0 = torch.sqrt(-2.0 * torch.log1p(-ua0))
        g_r1 = torch.sqrt(-2.0 * torch.log1p(-ua2))
        g0 = g_r0 * torch.cos(two_pi * ua1)
        g1 = g_r0 * torch.sin(two_pi * ua1)
        g2 = g_r1 * torch.cos(two_pi * ua3)
        g_sq = g0 * g0 + g1 * g1 + g2 * g2
        g_zero = torch.sqrt(g_sq) == 0.0
        inv_g = torch.rsqrt(torch.where(g_zero, 1.0, g_sq))
        uvx = torch.where(g_zero, g0, g0 * inv_g)
        uvy = torch.where(g_zero, g1, g1 * inv_g)
        uvz = torch.where(g_zero, g2, g2 * inv_g)
        # cube root as exp(log(u)/3), as the TPU kernel computes it
        crad = torch.exp(torch.log(torch.clamp(ub0, min=1e-30)) * (1.0 / 3.0))

        # ---- texture (solid / checker) ----
        sines = torch.sin(10.0 * px) * torch.sin(10.0 * py) * torch.sin(10.0 * pz)
        use2 = (ttype == TEX_CHECKER) & (sines < 0.0)
        tex_r = torch.where(use2, c2r, cr)
        tex_g = torch.where(use2, c2g, cg)
        tex_b = torch.where(use2, c2b, cb)
        # noise and image: computed for live hits on their own texture
        # only (megakernel.py:676-786); other rays keep the color above
        if tables.has_noise:
            need = alive & hit & (ttype == TEX_NOISE)
            turb = perlin_turb(perm, grad, px[need], py[need], pz[need])
            gray = 0.5 * (1.0 + torch.sin(gf(_AF_TSCALE)[need] * pz[need] + 10.0 * turb))
            tex_r, tex_g, tex_b = (t.masked_scatter(need, gray) for t in (tex_r, tex_g, tex_b))
        if tables.has_image:
            need = alive & hit & (ttype == TEX_IMAGE)
            rgb = _image_rgb(tables, j[need], is_s[need], onx[need], ony[need], onz[need],
                             px[need], py[need], pz[need])
            tex_r, tex_g, tex_b = (t.masked_scatter(need, c)
                                   for t, c in zip((tex_r, tex_g, tex_b), rgb))

        # ---- diffuse (material.zig:41-53) ----
        ddx, ddy, ddz = nx + uvx, ny + uvy, nz + uvz
        deg = ((torch.abs(ddx) < _NEAR_ZERO) & (torch.abs(ddy) < _NEAR_ZERO)
               & (torch.abs(ddz) < _NEAR_ZERO))
        ddx = torch.where(deg, nx, ddx)
        ddy = torch.where(deg, ny, ddy)
        ddz = torch.where(deg, nz, ddz)

        # ---- metal (material.zig:55-66) ----
        d_nsq = dx * dx + dy * dy + dz * dz
        inv_dn = torch.rsqrt(torch.where(d_nsq == 0.0, 1.0, d_nsq))
        ux, uy, uz = dx * inv_dn, dy * inv_dn, dz * inv_dn
        u_dot_n = ux * nx + uy * ny + uz * nz
        rx = ux - 2.0 * u_dot_n * nx
        ry = uy - 2.0 * u_dot_n * ny
        rz = uz - 2.0 * u_dot_n * nz
        mdx = rx + fuzz * (uvx * crad)
        mdy = ry + fuzz * (uvy * crad)
        mdz = rz + fuzz * (uvz * crad)
        metal_alive = (rx * nx + ry * ny + rz * nz) > 0.0

        # ---- dielectric (material.zig:68-92) ----
        ratio = torch.where(front, 1.0 / ior, ior)
        cos_t = torch.clamp(-u_dot_n, max=1.0)
        sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=1e-20))
        can_refract = ratio * sin_t <= 1.0
        r0 = (1.0 - ratio) / (1.0 + ratio)
        r0 = r0 * r0
        one_c = 1.0 - cos_t
        one_c5 = one_c * one_c
        one_c5 = one_c5 * one_c5 * one_c
        refl = r0 + (1.0 - r0) * one_c5
        do_refract = can_refract & (refl < ub1)
        perp_x = ratio * (ux + cos_t * nx)
        perp_y = ratio * (uy + cos_t * ny)
        perp_z = ratio * (uz + cos_t * nz)
        perp_sq = perp_x * perp_x + perp_y * perp_y + perp_z * perp_z
        par = -torch.sqrt(torch.clamp(torch.abs(1.0 - perp_sq), min=1e-12))
        gdx = torch.where(do_refract, perp_x + par * nx, rx)
        gdy = torch.where(do_refract, perp_y + par * ny, ry)
        gdz = torch.where(do_refract, perp_z + par * nz, rz)

        # ---- select by material ----
        is_metal = mtype == MAT_METAL
        is_diel = mtype == MAT_DIELECTRIC
        is_light = mtype == MAT_LIGHT
        ndx = torch.where(is_diel, gdx, torch.where(is_metal, mdx, ddx))
        ndy = torch.where(is_diel, gdy, torch.where(is_metal, mdy, ddy))
        ndz = torch.where(is_diel, gdz, torch.where(is_metal, mdz, ddz))
        at_r = torch.where(is_diel, 1.0, tex_r)
        at_g = torch.where(is_diel, 1.0, tex_g)
        at_b = torch.where(is_diel, 1.0, tex_b)
        sc_alive = (is_metal & metal_alive) | (~is_metal & ~is_light)

        # ---- accumulate (main.zig:110-121) ----
        hit_live = alive & hit
        miss_live = alive & ~hit
        em = hit_live & is_light
        if has_sky:
            # book-1 gradient sky (megakernel.py:861-870); inv_dn is the
            # reciprocal length of the CURRENT direction
            tsky = 0.5 * (dy * inv_dn + 1.0)
            sky_r = (1.0 - tsky) * bg_r + tsky * bg_r1
            sky_g = (1.0 - tsky) * bg_g + tsky * bg_g1
            sky_b = (1.0 - tsky) * bg_b + tsky * bg_b1
        else:
            sky_r, sky_g, sky_b = bg_r, bg_g, bg_b
        rr = rr + torch.where(em, tr * tex_r, 0.0) + torch.where(miss_live, tr * sky_r, 0.0)
        rg = rg + torch.where(em, tg * tex_g, 0.0) + torch.where(miss_live, tg * sky_g, 0.0)
        rb = rb + torch.where(em, tb * tex_b, 0.0) + torch.where(miss_live, tb * sky_b, 0.0)
        new_alive = hit_live & sc_alive
        tr = torch.where(new_alive, tr * at_r, tr)
        tg = torch.where(new_alive, tg * at_g, tg)
        tb = torch.where(new_alive, tb * at_b, tb)
        ox = torch.where(new_alive, px, ox)
        oy = torch.where(new_alive, py, oy)
        oz = torch.where(new_alive, pz, oz)
        dx = torch.where(new_alive, ndx, dx)
        dy = torch.where(new_alive, ndy, dy)
        dz = torch.where(new_alive, ndz, dz)
        # rows dead at entry keep their alive value; live rows become 0/1
        al_out = torch.where(state[:, S_AL] > 0.5, new_alive.to(torch.float32), al_out)
        alive = new_alive

    new_state = torch.stack([
        ox, oy, oz, dx, dy, dz, time, state[:, S_PID], state[:, S_SID],
        tr, tg, tb, al_out, state[:, S_RID],
    ], dim=1)
    rad = torch.stack([rr, rg, rb])
    if accum is not None:
        # a row dead at entry adds exactly +0.0, which changes no bit of
        # accum: the kernel's write-out, without a mask that would sync
        rid = _int_col(state, S_RID).long()
        for c in range(3):
            accum[c].index_add_(0, rid, rad[c])
        rad = None
    if want_winners:
        return rad, new_state, torch.stack(winners)
    return rad, new_state


def _check_cuda_args(tables: Tables, state: torch.Tensor):
    dev = state.device
    named = dict(coef=tables.coef, attr_f=tables.attr_f, attr_i=tables.attr_i,
                 perm=tables.perm, grad=tables.grad, images=tables.images, state=state)
    for name, t in named.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, state on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        want = torch.int32 if name in ("attr_i", "perm", "images") else torch.float32
        if t.dtype != want:
            raise TypeError(f"{name} must be {want}, got {t.dtype}")
    if tables.perm.shape != (8, 128) or tables.grad.shape != (8, 128):
        raise ValueError("perm/grad must be [8, 128]")
    n_rows = 2 * tables.s_pad + 6 * tables.r_pad
    if tables.coef.shape != (n_rows, 128):
        raise ValueError(f"coef must be [{n_rows}, 128], got {tuple(tables.coef.shape)}")
    if not (0 <= tables.s_live <= tables.s_pad and 0 <= tables.r_live <= tables.r_pad):
        raise ValueError(f"s_live/r_live ({tables.s_live}, {tables.r_live}) must lie within "
                         f"s_pad/r_pad ({tables.s_pad}, {tables.r_pad})")
    if tables.coef.data_ptr() % 16:
        raise ValueError("coef must be 16-byte aligned (the kernel bulk-copies its rows)")
    pc = tables.attr_f.shape[1]
    if tables.attr_f.shape[0] != 29 or tables.attr_i.shape != (5, pc) \
            or pc < tables.s_pad + tables.r_pad:
        raise ValueError("attr_f/attr_i must be [29, C*128] / [5, C*128]")
    if state.dim() != 2 or state.shape[1] != len(STATE_FIELDS):
        raise ValueError(f"state must be [m, {len(STATE_FIELDS)}], got {tuple(state.shape)}")
    if state.shape[0] >= _MAX_RAYS:
        raise ValueError("too many rays for one launch")
    if n_rows * _ROW_BYTES > _SMEM_LIMIT:
        raise ValueError(
            f"{n_rows} coefficient rows need {n_rows * _ROW_BYTES} bytes of "
            f"shared memory; the kernel stages at most {_SMEM_LIMIT}"
        )


BLOCK = 256   # threads a block (csrc/megakernel.cu's BLOCK)
GROUPS = (1, 2, 4, 8, 16, 32)   # lanes a ray the kernel takes
# launch_shape's thresholds, from timing every G at every segment of the
# render paths and at the train step's depth-50 launch on the H100
# (tools/segments.py --groups; PERF.md), counting the rows the scan reads.
# A scan-heavy table whose buffer fills the resident threads wants
# m * G >= (n_bounces + 3) * threads: a longer segment spreads its rays'
# lifetimes over more bounces, and more lanes a ray shorten the longest
# ones. A smaller buffer, or a small table whose shading dominates (extra
# lanes repeat it), wants 1.5 x threads.
_HEAVY_ROWS = 256     # a table of this many rows is scan-heavy
_FILL_SMALL = 1.5
_ROWS_PER_LANE = 8    # G <= n_rows / 8: each lane scans 8 rows or more


def launch_shape(m: int, n_sm: int, blocks_per_sm: int, n_rows: int, n_bounces: int,
                 group: int | None = None):
    """(G, blocks) of one persistent launch over m lanes, n_bounces bounces,
    n_rows coefficient rows scanned (2 s_live + 6 r_live): `blocks`
    resident blocks of BLOCK threads (the SM count times the blocks an SM
    holds, fewer if m * G lanes need fewer), G lanes a ray. G is the
    smallest of GROUPS up to n_rows / 8 for which m * G is at least F
    times the resident threads, F = n_bounces + 3 for _HEAVY_ROWS rows or
    more while m alone fills the threads, else 1.5; the largest allowed G
    if none is. `group` forces G."""
    full = n_sm * blocks_per_sm
    threads = full * BLOCK
    if group is None:
        top = max(g for g in GROUPS if g == 1 or g * _ROWS_PER_LANE <= n_rows)
        fill = (n_bounces + 3 if n_rows >= _HEAVY_ROWS and m >= threads
                else _FILL_SMALL)
        group = next((g for g in GROUPS if g <= top and m * g >= fill * threads), top)
    elif group not in GROUPS:
        raise ValueError(f"group must be one of {GROUPS}, got {group!r}")
    return group, max(1, min(full, -(-m * group // BLOCK)))


_COUNTERS: dict = {}


def _variant(tables: Tables, has_sky: bool) -> int:
    return (int(tables.has_motion) | 2 * int(tables.has_noise)
            | 4 * int(tables.has_image) | 8 * int(has_sky))


def _blocks_per_sm(lib, variant: int, want_winners: bool, n_rows: int) -> int:
    """Resident blocks an SM of the instantiation at this table size, on
    the current device (cached on the C side)."""
    out = ctypes.c_int(0)
    rc = lib.rtw_bounce_blocks_per_sm(n_rows, variant, int(want_winners), ctypes.byref(out))
    if rc != 0:
        msg = lib.rtw_error_string(rc).decode()
        raise RuntimeError(f"bounce kernel occupancy query failed: CUDA error {rc} ({msg})")
    if out.value < 1:
        raise RuntimeError(f"no block of the bounce kernel fits an SM at {n_rows} rows")
    return out.value


def _counter(dev, stream: int) -> torch.Tensor:
    """The next-ray counter of one (device, stream): one int32, zeroed by
    the C entry on the launch stream before each launch."""
    key = (dev.index, stream)
    if key not in _COUNTERS:
        _COUNTERS[key] = torch.zeros(1, dtype=torch.int32, device=dev)
    return _COUNTERS[key]


def _check_accum(accum, state: torch.Tensor):
    if accum.device != state.device:
        raise ValueError(f"accum is on {accum.device}, state on {state.device}")
    if accum.dtype != torch.float32 or not accum.is_contiguous():
        raise TypeError("accum must be a contiguous float32 tensor")
    if accum.dim() != 2 or accum.shape[0] != 3:
        raise ValueError(f"accum must be [3, cols], got {tuple(accum.shape)}")


def _launch(lib, tables: Tables, state, seed: int, bg, variant: int, b0: int,
            n_bounces: int, t_min: float, want_winners: bool, group: int, blocks: int,
            counter: torch.Tensor, stream: int, accum=None):
    """Allocate the outputs and launch once through the C entry; with
    accum, no radiance delta is allocated (None is returned for it)."""
    m = state.shape[0]
    rad = (torch.empty((3, m), dtype=torch.float32, device=state.device)
           if accum is None else None)
    out = torch.empty_like(state)
    # the kernel writes every entry, -1 after a ray's death included
    win = (torch.empty((n_bounces, m), dtype=torch.int32, device=state.device)
           if want_winners else None)
    rc = lib.rtw_bounce_segment(
        tables.coef.data_ptr(), tables.coef.shape[0], tables.coef.shape[1],
        tables.attr_f.data_ptr(), tables.attr_i.data_ptr(), tables.attr_f.shape[1],
        tables.s_pad, tables.r_pad, tables.s_live, tables.r_live, variant,
        tables.perm.data_ptr(), tables.grad.data_ptr(), tables.images.data_ptr(),
        state.data_ptr(), out.data_ptr(), None if rad is None else rad.data_ptr(),
        None if accum is None else accum.data_ptr(), 0 if accum is None else accum.shape[1],
        win.data_ptr() if want_winners else None, m,
        int(seed) & 0xFFFFFFFF, *bg, int(b0), int(n_bounces), float(t_min),
        group, blocks, counter.data_ptr(), stream,
    )
    if rc != 0:
        msg = lib.rtw_error_string(rc).decode()
        raise RuntimeError(f"bounce kernel launch failed: CUDA error {rc} ({msg})")
    return rad, out, win


def trace_segment(tables: Tables, state, seed: int, background, b0: int,
                  n_bounces: int, t_min: float = T_MIN, *, want_winners: bool = False,
                  accum=None, _group: int | None = None):
    """The bounce kernel (csrc/megakernel.cu) for CUDA tensors; the plain
    version for CPU tensors. Same contract as trace_segment_plain.

    One launch of persistent blocks (the SM count times the blocks an SM
    holds at this table size) that refill finished rays from a next-ray
    counter: one int32 per (device, stream), cached here and zeroed by the
    C entry on the launch stream. G lanes trace each ray, G from the lane
    count, the bounces and the rows scanned by launch_shape (1 or 2 for a
    full batch's short first segment, 8 for its depth-50 launch, up to 32
    for small buffers); `_group` forces G (tests). `last_shape` is the
    (G, blocks) of the last launch. LAUNCHES counts the launches.

    accum: the kernel adds each finished ray's radiance into accum[:,
    ray_id] as it writes the ray out, and writes no radiance delta (None
    is returned for it); rows dead at entry add nothing. Nothing is
    synchronised to check the ids: the live ray ids of the rows must be
    distinct and below accum's column count."""
    if state.device.type == "cpu":
        return trace_segment_plain(tables, state, seed, background, b0,
                                   n_bounces, t_min, want_winners=want_winners, accum=accum)
    if state.device.type != "cuda":
        raise ValueError(f"unsupported device {state.device}")
    bg, has_sky = sky_floats(background)
    _check_cuda_args(tables, state)
    if accum is not None:
        _check_accum(accum, state)
    from rtweekend_tpu_torch.ops.cuda import build

    lib, _ = build.load()
    dev = state.device
    variant = _variant(tables, has_sky)
    group, blocks = launch_shape(
        state.shape[0], torch.cuda.get_device_properties(dev).multi_processor_count,
        _blocks_per_sm(lib, variant, want_winners, tables.coef.shape[0]),
        2 * tables.s_live + 6 * tables.r_live, n_bounces, _group)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rad, out, win = _launch(lib, tables, state, seed, bg, variant, b0, n_bounces, t_min,
                            want_winners, group, blocks, _counter(dev, stream), stream, accum)
    trace_segment.last_shape = (group, blocks)
    LAUNCHES["launches"] += 1
    LAUNCHES["accum_launches"] += accum is not None
    LAUNCHES["noise_launches"] += tables.has_noise
    LAUNCHES["image_launches"] += tables.has_image
    LAUNCHES["sky_launches"] += has_sky
    if want_winners:
        LAUNCHES["winners_launches"] += 1
        return rad, out, win
    return rad, out


# launches of the hand-written kernels, by counter: "launches" counts the
# bounce kernel's of every variant, "winners_launches", "noise_launches",
# "image_launches" and "sky_launches" those with that variant compiled in,
# "raygen_launches" raygen_kernel's; "accum_launches" the bounce kernel's
# that added their radiance into a caller's buffer at the ray ids (every
# launch of trace_paths_compact on the card); "retrace_launches" counts
# render._Tracer.recover's uncompacted re-traces of overflowed batches, on
# every device
LAUNCH_COUNTS = ("launches", "winners_launches", "noise_launches", "image_launches",
                 "sky_launches", "raygen_launches", "retrace_launches", "accum_launches")
LAUNCHES = dict.fromkeys(LAUNCH_COUNTS, 0)


def reset_launch_counts():
    """Set every launch counter to 0."""
    LAUNCHES.update(dict.fromkeys(LAUNCH_COUNTS, 0))


def launch_counts():
    """The launch counters, by name."""
    return dict(LAUNCHES)


trace_segment.last_shape = None

KERNELS = ("auto", "cuda", "torch")


def segment_fn(kernel: str, device: torch.device):
    """The segment tracer for a kernel choice: "auto" and "cuda" go
    through the wrapper (kernel on the card, plain version on the CPU),
    "torch" is the plain version on any device."""
    if kernel not in KERNELS:
        raise ValueError(f"kernel must be one of {KERNELS}, got {kernel!r}")
    if kernel == "cuda" and device.type != "cuda":
        raise ValueError("kernel='cuda' needs tensors on a CUDA device")
    return trace_segment_plain if kernel == "torch" else trace_segment


def trace_paths(tables: Tables, origins, dirs, times, pixel_ids, sample_ids,
                seed: int, background, max_depth: int, *, kernel: str = "auto",
                return_winners: bool = False, t_min: float = T_MIN):
    """All bounces in one launch, no compaction (rtweekend_tpu
    `trace_paths_pallas`). Returns radiance [N, 3]; with return_winners,
    (radiance [N, 3], winners [max_depth, N] int32, -1 = miss or dead)."""
    n = origins.shape[0]
    state = init_state(origins, dirs, times, pixel_ids, sample_ids)
    fn = segment_fn(kernel, state.device)
    if return_winners:
        rad, _, win = fn(tables, state, seed, background, 0, max_depth, t_min,
                         want_winners=True)
        return rad[:, :n].t(), win[:, :n]
    rad, _ = fn(tables, state, seed, background, 0, max_depth, t_min)
    return rad[:, :n].t()


def _tiles(n: int) -> int:
    return max(TILE, -(-n // TILE) * TILE)


# Capacity schedules ((bounce, fraction), ...): entering bounce b the ray
# buffer shrinks to _tiles(fraction * n_rays). The same schedules as the
# JAX package (megakernel.py:1267-1288): OPEN for sky-lit scenes, whose
# wavefront collapses within a few bounces; CLOSED for enclosed scenes.
CAPS_OPEN = ((3, 0.45), (6, 0.10), (12, 0.02), (20, 0.010))
CAPS_CLOSED = ((8, 0.7), (16, 0.55), (32, 0.4))


def schedule(n: int, max_depth: int, capacities):
    """Segments [(b0, n_bounces, out_cap)] for n rays. Capacities are
    sorted and deduplicated; they only ever shrink the buffer."""
    caps = sorted(
        {b: _tiles(int(f * n)) for b, f in capacities if 0 < b < max_depth}.items()
    )
    boundaries = [b for b, _ in caps] + [max_depth]
    cap_at = dict(caps)
    segs = []
    b, cap = 0, _tiles(n)
    while b < max_depth:
        nxt = next(x for x in boundaries if x > b)
        out_cap = min(cap, cap_at.get(b, cap))
        segs.append((b, nxt - b, out_cap))
        cap, b = out_cap, nxt
    return segs


def compact(state, count, out_cap: int):
    """The first out_cap live rows of state, in ascending row order, as a
    prefix-sum scatter into a fixed capacity (no data-sized op, no host
    sync). `count` is the device-side alive count. Rows past the live ones
    repeat the last row and are marked dead (rtweekend_tpu
    megakernel.py:1185-1229, where jnp.nonzero(size=...) does this).
    Returns (compacted state [out_cap, 14], overflow flag)."""
    cap_prev = state.shape[0]
    dev = state.device
    alive = state[:, S_AL] > 0.5
    pos = torch.cumsum(alive, dim=0) - 1
    # live rows that fit go to their rank; everything else to a spill slot
    dest = torch.where(alive & (pos < out_cap), pos, out_cap)
    idx = torch.full((out_cap + 1,), cap_prev - 1, dtype=torch.int64, device=dev)
    idx.scatter_(0, dest, torch.arange(cap_prev, device=dev))
    g = state.index_select(0, idx[:out_cap])
    keep = (torch.arange(out_cap, device=dev) < count) & (g[:, S_AL] > 0.5)
    g[:, S_AL] = keep.to(torch.float32)
    return g, count > out_cap


def trace_paths_compact(tables: Tables, state, n: int, seed: int, background,
                        max_depth: int, *, capacities=CAPS_OPEN, kernel: str = "auto"):
    """Segmented tracing with wavefront compaction (rtweekend_tpu
    `trace_paths_pallas_compact`) of the n rays of a state from init_state
    or ray_state (rows past n dead; the state itself is left as it is).
    Returns (radiance [n, 3], overflow): both stay on the device. The
    radiance is bit-equal to trace_paths unless overflow is set, in which
    case live rays were dropped."""
    fn = segment_fn(kernel, state.device)
    dev = state.device
    # each segment adds its rays' radiance here at their ray ids (`accum`)
    total = torch.zeros((3, state.shape[0]), dtype=torch.float32, device=dev)
    # filled on the device: torch.tensor(n, device=dev) copies from the host and syncs
    count = torch.full((), n, dtype=torch.int64, device=dev)
    overflow = torch.zeros((), dtype=torch.bool, device=dev)
    for b0, n_b, out_cap in schedule(n, max_depth, capacities):
        if out_cap < state.shape[0]:
            state, ovf = compact(state, count, out_cap)
            overflow = overflow | ovf
        _, state = fn(tables, state, seed, background, b0, n_b, accum=total)
        count = (state[:, S_AL] > 0.5).sum()
    return total[:, :n].t(), overflow
