"""Thin-lens camera with a motion-blur shutter (reference src/main.zig:40-101).

`make_camera` is the reference's Camera.init, computed on the host in
numpy (float32 or float64) with the JAX package's op sequence; `generate_rays` is the
batched getRay plus per-sample pixel jitter, with counter-RNG draws; `batch_rays` the
rays of one sample batch of a render.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from rtweekend_tpu_torch.models.scene import numpy_dtype
from rtweekend_tpu_torch.utils import rng as rng_mod


@dataclasses.dataclass
class Camera:
    origin: torch.Tensor        # [3]
    horizontal: torch.Tensor    # [3]
    vertical: torch.Tensor      # [3]
    lower_left: torch.Tensor    # [3]
    u: torch.Tensor             # [3]
    v: torch.Tensor             # [3]
    w: torch.Tensor             # [3]
    lens_radius: torch.Tensor   # []
    time0: torch.Tensor         # []
    time1: torch.Tensor         # []


def make_camera(
    look_from, look_at, vup, vfov_deg: float, aspect_ratio: float,
    aperture: float, focus_dist: float, time0: float = 0.0, time1: float = 1.0,
    *, device, dtype=torch.float32,
) -> Camera:
    """Camera.init (reference src/main.zig:52-89), formula for formula, in
    `dtype` (torch.float32 or torch.float64)."""
    ft = numpy_dtype(dtype).type
    look_from = np.asarray(look_from, ft)
    look_at = np.asarray(look_at, ft)
    vup = np.asarray(vup, ft)

    theta = math.radians(vfov_deg)
    h = math.tan(theta / 2.0)
    viewport_height = 2.0 * h
    viewport_width = aspect_ratio * viewport_height

    def _normalized(x):
        # zero-guarded x * (1/sqrt(|x|^2)) (vec.zig:33-40)
        ns = ft(x[0] * x[0] + x[1] * x[1] + x[2] * x[2])
        if ns == 0.0:
            return x
        return (x * (ft(1.0) / np.sqrt(ns))).astype(ft)

    w = _normalized(look_from - look_at)
    u = _normalized(np.cross(vup, w).astype(ft))
    v = np.cross(w, u).astype(ft)

    origin = look_from
    horizontal = (u * ft(viewport_width * focus_dist)).astype(ft)
    vertical = (v * ft(viewport_height * focus_dist)).astype(ft)
    lower_left = (
        origin - horizontal / ft(2.0) - vertical / ft(2.0) - w * ft(focus_dist)
    ).astype(ft)

    t = lambda x: torch.as_tensor(np.asarray(x, ft), device=device)  # noqa: E731
    return Camera(
        origin=t(origin), horizontal=t(horizontal), vertical=t(vertical),
        lower_left=t(lower_left), u=t(u), v=t(v), w=t(w),
        lens_radius=t(aperture / 2.0), time0=t(time0), time1=t(time1),
    )


def generate_rays(camera: Camera, width: int, height: int, pixel_ids, sample_ids,
                  seed: int):
    """Batched Camera.getRay (main.zig:91-100) with the render loop's pixel
    jitter (main.zig:390-391).

    pixel_ids: int32 [N], j*width + i with j counted from the image BOTTOM;
    sample_ids: int32 [N]; seed: Python int (uint32).
    Returns (origins [N,3], dirs [N,3], times [N]) on the ids' device."""
    dtype = camera.origin.dtype
    i = (pixel_ids % width).to(dtype)
    j = torch.div(pixel_ids, width, rounding_mode="floor").to(dtype)

    u0 = rng_mod.uniform4(seed, pixel_ids, sample_ids, rng_mod.STREAM_CAMERA0, dtype)
    u1 = rng_mod.uniform4(seed, pixel_ids, sample_ids, rng_mod.STREAM_CAMERA1, dtype)

    s = (i + u0[:, 0]) / (width - 1.0)
    t = (j + u0[:, 1]) / (height - 1.0)

    rd = rng_mod.in_unit_disk_from_u(u0[:, 2], u0[:, 3]) * camera.lens_radius
    offset = camera.u[None, :] * rd[:, :1] + camera.v[None, :] * rd[:, 1:2]

    origins = camera.origin[None, :] + offset
    dirs = (
        camera.lower_left[None, :]
        + s[:, None] * camera.horizontal[None, :]
        + t[:, None] * camera.vertical[None, :]
        - camera.origin[None, :]
        - offset
    )
    times = camera.time0 + u1[:, 0] * (camera.time1 - camera.time0)
    return origins, dirs, times


def batch_rays(camera: Camera, seed: int, sample_start: int, *,
               width: int, height: int, n_samples: int, pixels=None):
    """The rays of every pixel of the id range `pixels` = (start, stop)
    (default: the whole image) with samples sample_start ..
    sample_start + n_samples - 1, pixel-major: (origins, dirs, times,
    pixel_ids, sample_ids)."""
    dev = camera.origin.device
    p0, p1 = (0, width * height) if pixels is None else pixels
    pixel_ids = torch.arange(p0, p1, dtype=torch.int32, device=dev).repeat_interleave(
        n_samples
    )
    sample_ids = sample_start + torch.arange(
        n_samples, dtype=torch.int32, device=dev
    ).repeat(p1 - p0)
    o, d, t = generate_rays(camera, width, height, pixel_ids, sample_ids, seed)
    return o, d, t, pixel_ids, sample_ids
