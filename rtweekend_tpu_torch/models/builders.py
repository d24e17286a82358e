"""Procedural scene generators (reference src/main.zig:124-293) plus the
book-cover `final_scene`.

The same algorithms and draw order as rtweekend_tpu.models.builders
against a seeded numpy Generator, so a scene built here from a seed
holds the same values as the JAX build from that seed.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from rtweekend_tpu_torch.device import resolve_device
from rtweekend_tpu_torch.models.scene import (
    Checker,
    Dielectric,
    Diffuse,
    DiffuseLight,
    ImageTex,
    Metal,
    Noise,
    SceneBuilder,
    Solid,
)

# Path of the earth texture: RTW_EARTH_TEXTURE, else the reference
# checkout's assets/sekaichizu.png, where rtweekend_tpu.models.builders
# looks for it too, so both packages build the same earth; without the
# file, earth uses the deterministic procedural map below.
EARTH_TEXTURE_PATH = os.environ.get(
    "RTW_EARTH_TEXTURE", "/root/reference/assets/sekaichizu.png"
)


def two_spheres(builder: SceneBuilder, rng: np.random.Generator):
    """generateTwoSpheres (main.zig:124-139)."""
    mat = builder.material(
        Diffuse(albedo=Checker(odd=(0.2, 0.3, 0.1), even=(0.9, 0.9, 0.9)))
    )
    builder.add_sphere((0.0, -10.0, 0.0), 10.0, mat)
    builder.add_sphere((0.0, 10.0, 0.0), 10.0, mat)


def two_perlin_spheres(builder: SceneBuilder, rng: np.random.Generator):
    """generateTwoPerlinSpheres (main.zig:141-155)."""
    mat = builder.material(Diffuse(albedo=Noise(scale=4.0)))
    builder.add_sphere((0.0, -1000.0, 0.0), 1000.0, mat)
    builder.add_sphere((0.0, 2.0, 0.0), 2.0, mat)


def _random_scene_grid(builder: SceneBuilder, rng: np.random.Generator, half: int,
                       checker_ground: bool = True, motion: bool = True):
    """generateRandomScene (main.zig:157-221) with a configurable grid
    half-width; checker_ground=False / motion=False give the book-1 form."""
    if checker_ground:
        ground_albedo = Checker(odd=(0.2, 0.3, 0.1), even=(0.9, 0.9, 0.9))
    else:
        ground_albedo = Solid((0.5, 0.5, 0.5))
    mat_ground = builder.material(Diffuse(albedo=ground_albedo))
    mat1 = builder.material(Dielectric(ir=1.5))
    mat2 = builder.material(Diffuse(albedo=Solid((0.4, 0.2, 0.1))))
    mat3 = builder.material(Metal(albedo=(0.7, 0.6, 0.5), fuzz=0.0))

    builder.add_sphere((0.0, -1000.0, 0.0), 1000.0, mat_ground)
    builder.add_sphere((0.0, 1.0, 0.0), 1.0, mat1)
    builder.add_sphere((-4.0, 1.0, 0.0), 1.0, mat2)
    builder.add_sphere((4.0, 1.0, 0.0), 1.0, mat3)

    for a in range(-half, half):
        for b in range(-half, half):
            choose_mat = rng.random()
            center = np.array(
                [a + 0.9 * rng.random(), 0.2, b + 0.9 * rng.random()]
            )
            # skip near the metal hero sphere (main.zig:188-190)
            if np.linalg.norm(center - np.array([4.0, 0.2, 0.0])) <= 0.9:
                continue
            if choose_mat < 0.8:
                # diffuse, moving upward (main.zig:193-205)
                albedo = rng.random(3) * rng.random(3)
                mat = builder.material(Diffuse(albedo=Solid(tuple(albedo))))
                if motion:
                    center1 = center + np.array([0.0, rng.uniform(0.0, 0.5), 0.0])
                    builder.add_moving_sphere(center, center1, 0.0, 1.0, 0.2, mat)
                else:
                    builder.add_sphere(center, 0.2, mat)
            elif choose_mat < 0.95:
                # metal (main.zig:206-211)
                albedo = rng.uniform(0.5, 1.0, 3)
                fuzz = rng.uniform(0.0, 0.5)
                mat = builder.material(Metal(albedo=tuple(albedo), fuzz=fuzz))
                builder.add_sphere(center, 0.2, mat)
            else:
                # glass (main.zig:212-216)
                mat = builder.material(Dielectric(ir=1.5))
                builder.add_sphere(center, 0.2, mat)


def random_scene(builder: SceneBuilder, rng: np.random.Generator):
    """generateRandomScene (main.zig:157-221): 6x6 grid."""
    _random_scene_grid(builder, rng, half=3)


def final_scene(builder: SceneBuilder, rng: np.random.Generator):
    """Book-cover scene: 22x22 grid (~485 spheres)."""
    _random_scene_grid(builder, rng, half=11)


def golden_scene(builder: SceneBuilder, rng: np.random.Generator):
    """Book-1 final scene (gray ground, static spheres, 22x22 grid); its
    gradient sky lives in config.SCENE_DEFAULTS['golden_scene']."""
    _random_scene_grid(builder, rng, half=11, checker_ground=False, motion=False)


def _procedural_earth_rgba(size=(256, 512)) -> np.ndarray:
    """Deterministic world-map texture for when the asset is absent. Ocean
    cells have alpha 0 (the alpha==0 -> ocean-blue path, texture.zig:138-140)."""
    h, w = size
    yy, xx = np.meshgrid(
        np.linspace(0, np.pi, h), np.linspace(0, 2 * np.pi, w), indexing="ij"
    )
    field = (
        np.sin(3 * xx) * np.sin(2 * yy)
        + 0.5 * np.sin(7 * xx + 1.3) * np.sin(5 * yy + 0.7)
        + 0.25 * np.sin(13 * xx + 2.1) * np.sin(11 * yy + 1.9)
    )
    land = field > 0.15
    rgba = np.zeros((h, w, 4), dtype=np.uint8)
    rgba[..., 0] = np.where(land, 60, 0)
    rgba[..., 1] = np.where(land, 160, 0)
    rgba[..., 2] = np.where(land, 70, 0)
    rgba[..., 3] = np.where(land, 255, 0)
    return rgba


def _load_earth_texture() -> np.ndarray:
    if os.path.exists(EARTH_TEXTURE_PATH):
        from rtweekend_tpu_torch.utils.image import read_image_rgba

        return read_image_rgba(EARTH_TEXTURE_PATH)
    return _procedural_earth_rgba()


def earth(builder: SceneBuilder, rng: np.random.Generator):
    """generateEarthScene (main.zig:223-234)."""
    tex = ImageTex(data=_load_earth_texture())
    mat = builder.material(Diffuse(albedo=tex))
    builder.add_sphere((0.0, 0.0, 0.0), 2.0, mat)


def simple_light(builder: SceneBuilder, rng: np.random.Generator):
    """generateSimpleLightScene (main.zig:236-257)."""
    mat = builder.material(Diffuse(albedo=Noise(scale=4.0)))
    builder.add_sphere((0.0, -1000.0, 0.0), 1000.0, mat)
    builder.add_sphere((0.0, 2.0, 0.0), 2.0, mat)
    light = builder.material(DiffuseLight(emit=Solid((4.0, 4.0, 4.0))))
    builder.add_rect("xy", 3.0, 5.0, 1.0, 3.0, -2.0, light)


def cornell_box(builder: SceneBuilder, rng: np.random.Generator):
    """generateCornellBox (main.zig:259-293): the 555 box with two
    rotated/translated boxes."""
    red = builder.material(Diffuse(albedo=Solid((0.65, 0.05, 0.05))))
    white = builder.material(Diffuse(albedo=Solid((0.73, 0.73, 0.73))))
    green = builder.material(Diffuse(albedo=Solid((0.12, 0.45, 0.15))))
    light = builder.material(DiffuseLight(emit=Solid((15.0, 15.0, 15.0))))

    builder.add_rect("yz", 0.0, 555.0, 0.0, 555.0, 555.0, green)
    builder.add_rect("yz", 0.0, 555.0, 0.0, 555.0, 0.0, red)
    builder.add_rect("xz", 213.0, 343.0, 227.0, 332.0, 554.0, light)
    builder.add_rect("xz", 0.0, 555.0, 0.0, 555.0, 0.0, white)
    builder.add_rect("xz", 0.0, 555.0, 0.0, 555.0, 555.0, white)
    builder.add_rect("xy", 0.0, 555.0, 0.0, 555.0, 555.0, white)

    # box1: 165x330x165, rotY(+15 deg), translate(265, 0, 295) (main.zig:284-286)
    builder.add_box(
        (0.0, 0.0, 0.0), (165.0, 330.0, 165.0), white,
        rot_y=np.radians(15.0), offset=(265.0, 0.0, 295.0),
    )
    # box2: 165^3, rotY(-18 deg), translate(130, 0, 65) (main.zig:288-290)
    builder.add_box(
        (0.0, 0.0, 0.0), (165.0, 165.0, 165.0), white,
        rot_y=np.radians(-18.0), offset=(130.0, 0.0, 65.0),
    )


def book1_diffuse(builder: SceneBuilder, rng: np.random.Generator):
    """Book-1 lambertian + ground."""
    ground = builder.material(Diffuse(albedo=Solid((0.5, 0.5, 0.5))))
    center = builder.material(Diffuse(albedo=Solid((0.5, 0.5, 0.5))))
    builder.add_sphere((0.0, -100.5, -1.0), 100.0, ground)
    builder.add_sphere((0.0, 0.0, -1.0), 0.5, center)


def book1_metal_dielectric(builder: SceneBuilder, rng: np.random.Generator):
    """Book-1 four-sphere scene with fuzz + hollow glass (the hollow shell
    is a NEGATIVE-radius inner sphere: the outward normal (p-c)/r flips)."""
    ground = builder.material(Diffuse(albedo=Solid((0.8, 0.8, 0.0))))
    center = builder.material(Diffuse(albedo=Solid((0.1, 0.2, 0.5))))
    glass = builder.material(Dielectric(ir=1.5))
    metal = builder.material(Metal(albedo=(0.8, 0.6, 0.2), fuzz=0.3))
    builder.add_sphere((0.0, -100.5, -1.0), 100.0, ground)
    builder.add_sphere((0.0, 0.0, -1.0), 0.5, center)
    builder.add_sphere((-1.0, 0.0, -1.0), 0.5, glass)
    builder.add_sphere((-1.0, 0.0, -1.0), -0.45, glass)  # hollow shell
    builder.add_sphere((1.0, 0.0, -1.0), 0.5, metal)


SCENES = {
    "random_scene": random_scene,
    "book1_diffuse": book1_diffuse,
    "book1_metal_dielectric": book1_metal_dielectric,
    # reuses the 4-sphere world with the defocus camera
    "book1_defocus": book1_metal_dielectric,
    "two_spheres": two_spheres,
    "two_perlin_spheres": two_perlin_spheres,
    "earth": earth,
    "simple_light": simple_light,
    "cornell_box": cornell_box,
    "final_scene": final_scene,
    "golden_scene": golden_scene,
}


def build_scene(name: str, seed: int = 42, device=None, dtype=torch.float32):
    """Build a registry scene on `device` (default: the card) in `dtype`
    (torch.float32 or torch.float64)."""
    dev = resolve_device(device)
    if name not in SCENES:
        raise KeyError(f"unknown scene {name!r}; have {sorted(SCENES)}")
    builder = SceneBuilder(perlin_seed=seed)
    SCENES[name](builder, np.random.default_rng(seed))
    return builder.build(dev, dtype)
