"""Render configuration and per-scene defaults (reference
src/main.zig:304-376), the same values as rtweekend_tpu.config."""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

# Float types a render may run in: float32 on every path, float64 on the
# eager integrator only (the bounce kernel is float32).
FLOAT_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def torch_dtype(dtype) -> torch.dtype:
    """torch.float32 or torch.float64 from a name or a torch dtype."""
    if isinstance(dtype, str):
        if dtype not in FLOAT_DTYPES:
            raise ValueError(f"dtype must be one of {sorted(FLOAT_DTYPES)}, got {dtype!r}")
        return FLOAT_DTYPES[dtype]
    if dtype not in FLOAT_DTYPES.values():
        raise ValueError(f"dtype must be torch.float32 or torch.float64, got {dtype!r}")
    return dtype


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    scene: str = "cornell_box"
    width: int = 600
    height: int = 600
    samples_per_pixel: int = 200
    max_depth: int = 50
    seed: int = 42
    # float32 on the card by default; float64 renders through the eager
    # integrator, as a high-precision oracle for the float32 paths.
    dtype: str = "float32"
    # Rays traced per batch; bounds the size of the ray-state buffers and
    # of the eager integrator's [rays, primitives] workspaces.
    rays_per_chunk: int = 1 << 20
    output: str = "out.png"

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)


# Per-scene defaults mirroring reference src/main.zig:320-362.
SCENE_DEFAULTS = {
    "random_scene": dict(
        width=600, height=400, samples_per_pixel=50, vfov=20.0, aperture=0.1,
        background=(0.70, 0.80, 1.00), look_from=(13, 2, 3), look_at=(0, 0, 0),
    ),
    "two_spheres": dict(
        width=600, height=400, samples_per_pixel=50, vfov=20.0, aperture=0.0,
        background=(0.70, 0.80, 1.00), look_from=(13, 2, 3), look_at=(0, 0, 0),
    ),
    "two_perlin_spheres": dict(
        width=600, height=400, samples_per_pixel=50, vfov=20.0, aperture=0.0,
        background=(0.70, 0.80, 1.00), look_from=(13, 2, 3), look_at=(0, 0, 0),
    ),
    "earth": dict(
        width=600, height=400, samples_per_pixel=50, vfov=20.0, aperture=0.0,
        background=(0.70, 0.80, 1.00), look_from=(13, 2, 3), look_at=(0, 0, 0),
    ),
    "simple_light": dict(
        width=600, height=400, samples_per_pixel=400, vfov=20.0, aperture=0.0,
        background=(0.0, 0.0, 0.0), look_from=(26, 3, 6), look_at=(0, 2, 0),
    ),
    "cornell_box": dict(
        width=600, height=600, samples_per_pixel=200, vfov=40.0, aperture=0.0,
        background=(0.0, 0.0, 0.0), look_from=(278, 278, -800), look_at=(278, 278, 0),
    ),
    # Book-cover final scene: the reference's generateRandomScene with the
    # book's 22x22 grid instead of 6x6 (reference src/main.zig:177-180).
    "final_scene": dict(
        width=1200, height=675, samples_per_pixel=500, vfov=20.0, aperture=0.1,
        background=(0.70, 0.80, 1.00), look_from=(13, 2, 3), look_at=(0, 0, 0),
    ),
    # Book-1 final scene under the book-1 GRADIENT sky: background is a
    # (bottom, top) pair lerped by ray elevation.
    "golden_scene": dict(
        width=600, height=400, samples_per_pixel=100, vfov=20.0, aperture=0.1,
        background=((1.0, 1.0, 1.0), (0.5, 0.7, 1.0)),
        look_from=(13, 2, 3), look_at=(0, 0, 0),
    ),
    "book1_diffuse": dict(
        width=200, height=100, samples_per_pixel=10, vfov=90.0, aperture=0.0,
        background=(0.70, 0.80, 1.00), look_from=(0, 0, 0), look_at=(0, 0, -1),
        focus_dist=1.0,
    ),
    "book1_metal_dielectric": dict(
        width=400, height=225, samples_per_pixel=50, vfov=90.0, aperture=0.0,
        background=(0.70, 0.80, 1.00), look_from=(0, 0, 0), look_at=(0, 0, -1),
        focus_dist=1.0,
    ),
    "book1_defocus": dict(
        width=400, height=225, samples_per_pixel=100, vfov=20.0, aperture=2.0,
        background=(0.70, 0.80, 1.00), look_from=(3, 3, 2), look_at=(0, 0, -1),
        # focus on the center sphere: |lookfrom - lookat|
        focus_dist=float((3**2 + 3**2 + 3**2) ** 0.5),
    ),
}

# Shared camera constants: reference src/main.zig:366-376.
VUP: Tuple[float, float, float] = (0.0, 1.0, 0.0)
FOCUS_DIST: float = 10.0
TIME0: float = 0.0
TIME1: float = 1.0
