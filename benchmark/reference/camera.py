"""Counter-based sampling (PCG4D) and the thin-lens camera with a shutter.

Every random draw is a pure function of (seed, pixel id, sample id,
stream): the PCG4D hash (Jarzynski and Olano, JCGT 2020) of the four
words. Words are carried in int64 holding [0, 2^32), each product split
into 16-bit halves, so the hash is exact on every device. Camera and
ray generation follow the reference's Camera.init and getRay
(main.zig:40-101) with the render loop's pixel jitter (main.zig:390-391),
in float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch

STREAM_CAMERA0 = 0xC0FFEE00
STREAM_CAMERA1 = 0xC0FFEE01
BOUNCE_STREAM0 = 0x10000
_MASK = 0xFFFFFFFF


def _word(x, device):
    if isinstance(x, int):
        return torch.tensor(x & _MASK, dtype=torch.int64, device=device)
    return x.to(torch.int64) & _MASK


def _mul(a, b):
    al, ah, bl, bh = a & 0xFFFF, a >> 16, b & 0xFFFF, b >> 16
    return (al * bl + (((ah * bl + al * bh) & 0xFFFF) << 16)) & _MASK


def pcg4d(a, b, c, d, device):
    x, y, z, w = ((_word(v, device) * 1664525 + 1013904223) & _MASK for v in (a, b, c, d))
    for shift in (True, False):
        x = (x + _mul(y, w)) & _MASK
        y = (y + _mul(z, x)) & _MASK
        z = (z + _mul(x, y)) & _MASK
        w = (w + _mul(y, z)) & _MASK
        if shift:
            x, y, z, w = x ^ (x >> 16), y ^ (y >> 16), z ^ (z >> 16), w ^ (w >> 16)
    return x, y, z, w


def unit(bits):
    """A word as a float32 in [0, 1) from its top 24 bits."""
    return (bits >> 8).to(torch.float32) * (2.0 ** -24)


def camera(look_from, look_at, vfov: float, aspect: float, aperture: float,
           focus_dist: float = 10.0):
    """Camera.init (main.zig:52-89) in float32 NumPy: origin, horizontal,
    vertical, lower-left corner, u, v, lens radius."""
    f = np.float32
    look_from, look_at = np.asarray(look_from, f), np.asarray(look_at, f)
    vup = np.asarray((0.0, 1.0, 0.0), f)
    h = math.tan(math.radians(vfov) / 2.0)
    vh = 2.0 * h
    vw = aspect * vh

    def normalized(x):
        ns = f(x[0] * x[0] + x[1] * x[1] + x[2] * x[2])
        return x if ns == 0.0 else (x * (f(1.0) / np.sqrt(ns))).astype(f)

    w = normalized(look_from - look_at)
    u = normalized(np.cross(vup, w).astype(f))
    v = np.cross(w, u).astype(f)
    horizontal = (u * f(vw * focus_dist)).astype(f)
    vertical = (v * f(vh * focus_dist)).astype(f)
    lower_left = (look_from - horizontal / f(2.0) - vertical / f(2.0)
                  - w * f(focus_dist)).astype(f)
    return dict(origin=look_from, horizontal=horizontal, vertical=vertical,
                lower_left=lower_left, u=u, v=v, lens_radius=f(aperture / 2.0))


def rays(cam: dict, width: int, height: int, pixel_ids, sample_ids, seed: int):
    """(origins [N, 3], directions [N, 3], times [N]) of the rays of pixel
    ids (j * width + i, j counted from the image bottom) and sample ids,
    on their device."""
    dev = pixel_ids.device
    t = {k: torch.as_tensor(np.asarray(val), device=dev) for k, val in cam.items()}
    i = (pixel_ids % width).to(torch.float32)
    j = torch.div(pixel_ids, width, rounding_mode="floor").to(torch.float32)
    u0 = [unit(x) for x in pcg4d(pixel_ids, sample_ids, STREAM_CAMERA0, seed, dev)]
    u1 = unit(pcg4d(pixel_ids, sample_ids, STREAM_CAMERA1, seed, dev)[0])
    s = (i + u0[0]) / (width - 1.0)
    tt = (j + u0[1]) / (height - 1.0)
    r = torch.sqrt(u0[2])
    theta = (2.0 * math.pi) * u0[3]
    rd_x, rd_y = r * torch.cos(theta) * t["lens_radius"], r * torch.sin(theta) * t["lens_radius"]
    offset = t["u"][None, :] * rd_x[:, None] + t["v"][None, :] * rd_y[:, None]
    origins = t["origin"][None, :] + offset
    dirs = (t["lower_left"][None, :] + s[:, None] * t["horizontal"][None, :]
            + tt[:, None] * t["vertical"][None, :] - t["origin"][None, :] - offset)
    times = 0.0 + u1 * (1.0 - 0.0)
    return origins, dirs, times
