"""The Cornell box of *Ray Tracing: The Next Week* as plain NumPy tables, in
the textbook form of the reference ray tracer's `generateCornellBox`
(main.zig:259-293).

Each rect is kept as the reference holds it: its plane family, plane
offset k, in-plane bounds [a0, a1] x [b0, b1] and material, with the
RotateY angle and Translate offset of the instance that wraps it
(hittable.zig:472-608) kept beside it, not baked into world-space rows.
A box is its 6 rects in `Box.init`'s order (hittable.zig:434-451), each
carrying the box's transform. The materials are red, white, green and the
light, in the reference's order; their colours are solid textures.

Families: 0 = xy (plane z = k; a along x, b along y), 1 = xz (plane y = k;
a along x, b along z), 2 = yz (plane x = k; a along y, b along z).
"""

from __future__ import annotations

import numpy as np

from benchmark.reference.scenes import MAT_DIFFUSE, MAT_LIGHT, TEX_SOLID

XY, XZ, YZ = 0, 1, 2
# (axis of the plane's normal, axis of a, axis of b) of each family
AXES = {XY: (2, 0, 1), XZ: (1, 0, 2), YZ: (0, 1, 2)}


def _box(p0, p1, mat, rot_y, offset):
    """Box.init (hittable.zig:434-451): two xy, two xz, two yz rects."""
    (x0, y0, z0), (x1, y1, z1) = p0, p1
    sides = [(XY, z1, x0, x1, y0, y1), (XY, z0, x0, x1, y0, y1),
             (XZ, y1, x0, x1, z0, z1), (XZ, y0, x0, x1, z0, z1),
             (YZ, x1, y0, y1, z0, z1), (YZ, x0, y0, y1, z0, z1)]
    return [(f, k, a0, a1, b0, b1, mat, rot_y, offset) for f, k, a0, a1, b0, b1 in sides]


def cornell_box() -> dict:
    """generateCornellBox (main.zig:259-293) as host arrays: rects family,
    k, a0, a1, b0, b1, rect_mat, rot_y (degrees), offset [R, 3]; no
    spheres; materials mtype, tex_id, fuzz, ior; textures ttype, color,
    color2 (the tables reference.scenes.build makes, so the same scatter
    code reads them)."""
    red, white, green, light = 0, 1, 2, 3
    colors = [(0.65, 0.05, 0.05), (0.73, 0.73, 0.73), (0.12, 0.45, 0.15), (15.0, 15.0, 15.0)]
    mtypes = [MAT_DIFFUSE, MAT_DIFFUSE, MAT_DIFFUSE, MAT_LIGHT]
    plain = (0.0, (0.0, 0.0, 0.0))
    rects = [
        (YZ, 555.0, 0.0, 555.0, 0.0, 555.0, green, *plain),
        (YZ, 0.0, 0.0, 555.0, 0.0, 555.0, red, *plain),
        (XZ, 554.0, 213.0, 343.0, 227.0, 332.0, light, *plain),
        (XZ, 0.0, 0.0, 555.0, 0.0, 555.0, white, *plain),
        (XZ, 555.0, 0.0, 555.0, 0.0, 555.0, white, *plain),
        (XY, 555.0, 0.0, 555.0, 0.0, 555.0, white, *plain),
    ]
    # box1: 165 x 330 x 165, RotateY(15), then Translate(265, 0, 295)
    rects += _box((0.0, 0.0, 0.0), (165.0, 330.0, 165.0), white, 15.0, (265.0, 0.0, 295.0))
    # box2: 165^3, RotateY(-18), then Translate(130, 0, 65)
    rects += _box((0.0, 0.0, 0.0), (165.0, 165.0, 165.0), white, -18.0, (130.0, 0.0, 65.0))

    cols = list(zip(*rects))
    n = len(colors)
    out = dict(family=np.asarray(cols[0], np.int64), rect_mat=np.asarray(cols[6], np.int64),
               rot_y=np.asarray(cols[7], np.float64), offset=np.asarray(cols[8], np.float64),
               n_rects=len(rects))
    for key, col in zip(("k", "a0", "a1", "b0", "b1"), cols[1:6]):
        out[key] = np.asarray(col, np.float64)
    out.update(
        c0=np.zeros((0, 3)), dc=np.zeros((0, 3)), time0=np.zeros(0), inv_dt=np.ones(0),
        radius=np.ones(0), mat_id=np.zeros(0, np.int64), n_spheres=0,
        mtype=np.asarray(mtypes, np.int64), tex_id=np.arange(n, dtype=np.int64),
        fuzz=np.zeros(n), ior=np.ones(n), ttype=np.full(n, TEX_SOLID, np.int64),
        color=np.asarray(colors, np.float64), color2=np.zeros((n, 3)))
    return out


SCENES = {"cornell_box": cornell_box}


def build(name: str) -> dict:
    """The rect scene `name` (no seed: its layout is fixed)."""
    if name not in SCENES:
        raise KeyError(f"unknown rect scene {name!r}; have {sorted(SCENES)}")
    return SCENES[name]()


def world_corners(sc: dict) -> tuple:
    """(corners [R, 4, 3], outward normals [R, 3]) of every rect in world
    space, float64: the object-space corners (a0, b0), (a1, b0), (a1, b1),
    (a0, b1) rotated by RotateY and translated, as RotateY and Translate
    map a hit point and normal back (hittable.zig:478-489, :584-590)."""
    r = sc["n_rects"]
    corners = np.zeros((r, 4, 3))
    normals = np.zeros((r, 3))
    for i in range(r):
        n_ax, a_ax, b_ax = AXES[int(sc["family"][i])]
        for c, (a, b) in enumerate(((sc["a0"][i], sc["b0"][i]), (sc["a1"][i], sc["b0"][i]),
                                    (sc["a1"][i], sc["b1"][i]), (sc["a0"][i], sc["b1"][i]))):
            corners[i, c, n_ax], corners[i, c, a_ax], corners[i, c, b_ax] = sc["k"][i], a, b
        normals[i, n_ax] = 1.0
    th = np.radians(sc["rot_y"])[:, None]
    cos, sin = np.cos(th), np.sin(th)

    def to_world(p):
        x = cos * p[..., 0] + sin * p[..., 2]
        z = -sin * p[..., 0] + cos * p[..., 2]
        return np.stack([x, p[..., 1], z], axis=-1)

    return to_world(corners) + sc["offset"][:, None, :], to_world(normals[:, None, :])[:, 0]
