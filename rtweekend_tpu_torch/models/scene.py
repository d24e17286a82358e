"""SoA scene representation and host-side scene builder.

The same padded structure-of-arrays scene as rtweekend_tpu.models.scene,
held as plain dataclasses of tensors: spheres (static and moving
unified), axis-aligned rects with baked rotate-Y/translate rows (boxes
become 6 rects), and flat material/texture tables indexed by id. The
builder works in numpy on the host and moves the finished arrays to the
device once (`SceneBuilder.build(device)`), so a scene built here holds
exactly the values the JAX builder makes from the same seed.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple, Union

import numpy as np
import torch

from rtweekend_tpu_torch.utils import perlin as perlin_mod

# Material type codes (reference src/rtw/material.zig:16-21).
MAT_DIFFUSE = 0
MAT_METAL = 1
MAT_DIELECTRIC = 2
MAT_LIGHT = 3

# Texture type codes (reference src/rtw/texture.zig:10-15).
TEX_SOLID = 0
TEX_CHECKER = 1
TEX_NOISE = 2
TEX_IMAGE = 3

# Rect axis families: (normal_axis, u_axis, v_axis) in object space
# (hittable.zig:270-427).
RECT_AXES = {
    "xy": (2, 0, 1),
    "xz": (1, 0, 2),
    "yz": (0, 1, 2),
}


@dataclasses.dataclass
class Spheres:
    """center(t) = c0 + dc * (t - time0) * inv_dt (hittable.zig:219-221)."""

    c0: torch.Tensor        # [S, 3]
    dc: torch.Tensor        # [S, 3] = center1 - center0
    time0: torch.Tensor     # [S]
    inv_dt: torch.Tensor    # [S]
    radius: torch.Tensor    # [S]
    mat_id: torch.Tensor    # [S] int32
    active: torch.Tensor    # [S] bool (False for padding)


@dataclasses.dataclass
class Rects:
    """Object-space coordinates q(p) = w_q . p + b_q for q in (n, a, b);
    k is the plane offset and [a0,a1]x[b0,b1] the in-plane bounds."""

    wn: torch.Tensor        # [R, 3]
    bn: torch.Tensor        # [R]
    wa: torch.Tensor        # [R, 3]
    ba: torch.Tensor        # [R]
    wb: torch.Tensor        # [R, 3]
    bb: torch.Tensor        # [R]
    k: torch.Tensor         # [R]
    a0: torch.Tensor        # [R]
    a1: torch.Tensor        # [R]
    b0: torch.Tensor        # [R]
    b1: torch.Tensor        # [R]
    normal: torch.Tensor    # [R, 3] world-space outward normal
    mat_id: torch.Tensor    # [R] int32
    active: torch.Tensor    # [R] bool


@dataclasses.dataclass
class Materials:
    mtype: torch.Tensor     # [M] int32
    tex_id: torch.Tensor    # [M] int32
    fuzz: torch.Tensor      # [M]
    ior: torch.Tensor       # [M]


@dataclasses.dataclass
class Textures:
    ttype: torch.Tensor     # [K] int32
    color: torch.Tensor     # [K, 3] solid color / checker even
    color2: torch.Tensor    # [K, 3] checker odd
    scale: torch.Tensor     # [K] noise scale
    image_id: torch.Tensor  # [K] int32


@dataclasses.dataclass
class Scene:
    spheres: Spheres
    rects: Rects
    materials: Materials
    textures: Textures
    perlin_grad: torch.Tensor   # [256, 3]
    perlin_px: torch.Tensor     # [256] int32
    perlin_py: torch.Tensor     # [256] int32
    perlin_pz: torch.Tensor     # [256] int32
    images: torch.Tensor        # [n_img, H, W, 4] uint8, padded
    image_h: torch.Tensor       # [n_img] int32
    image_w: torch.Tensor       # [n_img] int32
    # every image flattened row-major at its true width, RGBA packed into
    # one int32 (r | g<<8 | b<<16 | a<<24), concatenated, [C, 128]
    images_packed: torch.Tensor
    image_base: torch.Tensor    # [n_img] int32 first texel of each image
    n_spheres: int = 0
    n_rects: int = 0
    has_checker: bool = False
    has_noise: bool = False
    has_image: bool = False
    has_motion: bool = False

    @property
    def device(self) -> torch.device:
        return self.spheres.c0.device


# Leaf groups of a Scene, in field order (used by convert.py).
LEAF_GROUPS = {
    "spheres": Spheres,
    "rects": Rects,
    "materials": Materials,
    "textures": Textures,
}
TOP_LEAVES = (
    "perlin_grad", "perlin_px", "perlin_py", "perlin_pz", "images",
    "image_h", "image_w", "images_packed", "image_base",
)


# ---------------------------------------------------------------------------
# Host-side description types consumed by SceneBuilder.


@dataclasses.dataclass(frozen=True)
class Solid:
    color: Tuple[float, float, float]


@dataclasses.dataclass(frozen=True)
class Checker:
    odd: Tuple[float, float, float]
    even: Tuple[float, float, float]


@dataclasses.dataclass(frozen=True)
class Noise:
    scale: float


@dataclasses.dataclass(frozen=True)
class ImageTex:
    # uint8 RGBA array; hashed by identity for dedup.
    data: "np.ndarray"

    def __hash__(self):
        return id(self.data)

    def __eq__(self, other):
        return isinstance(other, ImageTex) and other.data is self.data


TextureDesc = Union[Solid, Checker, Noise, ImageTex]


@dataclasses.dataclass(frozen=True)
class Diffuse:
    albedo: TextureDesc


@dataclasses.dataclass(frozen=True)
class Metal:
    albedo: Tuple[float, float, float]
    fuzz: float


@dataclasses.dataclass(frozen=True)
class Dielectric:
    ir: float


@dataclasses.dataclass(frozen=True)
class DiffuseLight:
    emit: TextureDesc


MaterialDesc = Union[Diffuse, Metal, Dielectric, DiffuseLight]


def _pad_to(n: int, multiple: int = 8) -> int:
    return max(multiple, ((n + multiple - 1) // multiple) * multiple)


class SceneBuilder:
    """Accumulates primitives host-side and freezes them to a padded Scene
    (boxes decompose into 6 rects; instance transforms are baked into
    per-rect affine rows, hittable.zig:35-45, :429-608)."""

    def __init__(self, perlin_seed: int = 42):
        self._textures: list = []
        self._materials: list = []
        self._spheres: list = []
        self._rects: list = []
        self._images: list = []
        self._tex_index: dict = {}
        self._mat_index: dict = {}
        self._img_index: dict = {}
        self.perlin_seed = perlin_seed

    def texture(self, desc: TextureDesc) -> int:
        if desc in self._tex_index:
            return self._tex_index[desc]
        if isinstance(desc, ImageTex) and id(desc.data) not in self._img_index:
            self._img_index[id(desc.data)] = len(self._images)
            self._images.append(np.asarray(desc.data, dtype=np.uint8))
        tid = len(self._textures)
        self._textures.append(desc)
        self._tex_index[desc] = tid
        return tid

    def material(self, desc: MaterialDesc) -> int:
        if desc in self._mat_index:
            return self._mat_index[desc]
        if isinstance(desc, Metal) and not 0.0 <= desc.fuzz <= 1.0:
            # the reference asserts fuzz <= 1 (material.zig:60)
            raise ValueError(f"metal fuzz must be in [0, 1], got {desc.fuzz}")
        if isinstance(desc, Diffuse):
            self.texture(desc.albedo)
        elif isinstance(desc, DiffuseLight):
            self.texture(desc.emit)
        mid = len(self._materials)
        self._materials.append(desc)
        self._mat_index[desc] = mid
        return mid

    def add_sphere(self, center, radius: float, mat_id: int):
        """Static sphere (hittable.zig:90-155)."""
        self._spheres.append((tuple(center), tuple(center), 0.0, 1.0, radius, mat_id))

    def add_moving_sphere(
        self, center0, center1, time0: float, time1: float, radius: float, mat_id: int
    ):
        """Linearly moving sphere (hittable.zig:157-226)."""
        self._spheres.append(
            (tuple(center0), tuple(center1), time0, time1, radius, mat_id)
        )

    def add_rect(
        self, family: str, a0: float, a1: float, b0: float, b1: float, k: float,
        mat_id: int, rot_y: float = 0.0, offset=(0.0, 0.0, 0.0),
    ):
        """Axis-aligned rect; rot_y (radians) and offset bake the
        reference's RotateY/Translate wrappers, translate applied first
        (Translate wraps RotateY in generateCornellBox, main.zig:284-290)."""
        n_ax, a_ax, b_ax = RECT_AXES[family]
        c, s = math.cos(rot_y), math.sin(rot_y)
        # world->object rotation rows (RotateY.hit, hittable.zig:563-567)
        rw2o = np.array([[c, 0.0, -s], [0.0, 1.0, 0.0], [s, 0.0, c]])
        off = np.asarray(offset, dtype=np.float64)
        rows = []
        for ax in (n_ax, a_ax, b_ax):
            w = rw2o[ax]
            rows.append((w, -float(w @ off)))
        e_n = np.zeros(3)
        e_n[n_ax] = 1.0
        normal_world = rw2o.T @ e_n  # object->world normal (hittable.zig:584-590)
        self._rects.append((rows, float(k), a0, a1, b0, b1, normal_world, mat_id))

    def add_box(self, p0, p1, mat_id: int, rot_y: float = 0.0, offset=(0.0, 0.0, 0.0)):
        """Box as 6 rects sharing one material (hittable.zig:434-451)."""
        x0, y0, z0 = p0
        x1, y1, z1 = p1
        kw = dict(rot_y=rot_y, offset=offset)
        self.add_rect("xy", x0, x1, y0, y1, z1, mat_id, **kw)
        self.add_rect("xy", x0, x1, y0, y1, z0, mat_id, **kw)
        self.add_rect("xz", x0, x1, z0, z1, y1, mat_id, **kw)
        self.add_rect("xz", x0, x1, z0, z1, y0, mat_id, **kw)
        self.add_rect("yz", y0, y1, z0, z1, x1, mat_id, **kw)
        self.add_rect("yz", y0, y1, z0, z1, x0, mat_id, **kw)

    def build_numpy(self, dtype=np.float32) -> Tuple[dict, dict]:
        """Freeze to host arrays: (leaves keyed "group.field" or "field",
        static metadata). Float leaves are converted from the float64
        host values to `dtype` (np.float32 or np.float64) once, here."""
        flt = lambda x: np.asarray(x, dtype=dtype)  # noqa: E731
        i32 = lambda x: np.asarray(x, dtype=np.int32)  # noqa: E731
        leaves = {}

        ns, nr = len(self._spheres), len(self._rects)
        ps, pr = _pad_to(ns), _pad_to(nr)

        # padding spheres are inactive and pushed far away
        c0 = np.zeros((ps, 3)); c1 = np.zeros((ps, 3))
        t0 = np.zeros(ps); t1 = np.ones(ps)
        rad = np.ones(ps); smat = np.zeros(ps, dtype=np.int32)
        sact = np.zeros(ps, dtype=bool)
        c0[:, 1] = c1[:, 1] = 1e9
        for idx, (a, b, u0, u1, r, m) in enumerate(self._spheres):
            c0[idx] = a; c1[idx] = b
            t0[idx] = u0; t1[idx] = u1 if u1 != u0 else u0 + 1.0
            rad[idx] = r; smat[idx] = m; sact[idx] = True
        leaves.update({
            "spheres.c0": flt(c0), "spheres.dc": flt(c1 - c0),
            "spheres.time0": flt(t0), "spheres.inv_dt": flt(1.0 / (t1 - t0)),
            "spheres.radius": flt(rad), "spheres.mat_id": i32(smat),
            "spheres.active": sact,
        })

        # padding rects get degenerate bounds so they never hit
        wn = np.zeros((pr, 3)); wn[:, 2] = 1.0
        bn = np.zeros(pr); wa = np.zeros((pr, 3)); wa[:, 0] = 1.0
        ba = np.zeros(pr); wb = np.zeros((pr, 3)); wb[:, 1] = 1.0
        bb = np.zeros(pr)
        k = np.full(pr, 1e9); ra0 = np.zeros(pr); ra1 = np.full(pr, -1.0)
        rb0 = np.zeros(pr); rb1 = np.full(pr, -1.0)
        nrm = np.zeros((pr, 3)); nrm[:, 2] = 1.0
        rmat = np.zeros(pr, dtype=np.int32); ract = np.zeros(pr, dtype=bool)
        for idx, (rows, kk, a0, a1, b0, b1, n_w, m) in enumerate(self._rects):
            (w0, b0_), (w1, b1_), (w2, b2_) = rows
            wn[idx], bn[idx] = w0, b0_
            wa[idx], ba[idx] = w1, b1_
            wb[idx], bb[idx] = w2, b2_
            k[idx] = kk; ra0[idx] = a0; ra1[idx] = a1
            rb0[idx] = b0; rb1[idx] = b1
            nrm[idx] = n_w; rmat[idx] = m; ract[idx] = True
        leaves.update({
            "rects.wn": flt(wn), "rects.bn": flt(bn), "rects.wa": flt(wa),
            "rects.ba": flt(ba), "rects.wb": flt(wb), "rects.bb": flt(bb),
            "rects.k": flt(k), "rects.a0": flt(ra0), "rects.a1": flt(ra1),
            "rects.b0": flt(rb0), "rects.b1": flt(rb1), "rects.normal": flt(nrm),
            "rects.mat_id": i32(rmat), "rects.active": ract,
        })

        nm = max(1, len(self._materials))
        mtype = np.zeros(nm, dtype=np.int32); mtex = np.zeros(nm, dtype=np.int32)
        fuzz = np.zeros(nm); ior = np.ones(nm)
        tex_descs = list(self._textures)

        def solid_id(color):
            d = Solid(tuple(float(x) for x in color))
            if d in self._tex_index:
                return self._tex_index[d]
            tid = len(tex_descs)
            tex_descs.append(d)
            self._tex_index[d] = tid
            return tid

        for idx, m in enumerate(self._materials):
            if isinstance(m, Diffuse):
                mtype[idx] = MAT_DIFFUSE
                mtex[idx] = self._tex_index[m.albedo]
            elif isinstance(m, Metal):
                mtype[idx] = MAT_METAL
                mtex[idx] = solid_id(m.albedo)
                fuzz[idx] = m.fuzz
            elif isinstance(m, Dielectric):
                mtype[idx] = MAT_DIELECTRIC
                ior[idx] = m.ir
            elif isinstance(m, DiffuseLight):
                mtype[idx] = MAT_LIGHT
                mtex[idx] = self._tex_index[m.emit]
            else:
                raise TypeError(m)
        leaves.update({
            "materials.mtype": i32(mtype), "materials.tex_id": i32(mtex),
            "materials.fuzz": flt(fuzz), "materials.ior": flt(ior),
        })

        nt = max(1, len(tex_descs))
        ttype = np.zeros(nt, dtype=np.int32)
        color = np.ones((nt, 3)); color2 = np.zeros((nt, 3))
        scale = np.ones(nt); image_id = np.zeros(nt, dtype=np.int32)
        for idx, t in enumerate(tex_descs):
            if isinstance(t, Solid):
                ttype[idx] = TEX_SOLID; color[idx] = t.color
            elif isinstance(t, Checker):
                ttype[idx] = TEX_CHECKER
                color[idx] = t.even; color2[idx] = t.odd
            elif isinstance(t, Noise):
                ttype[idx] = TEX_NOISE; scale[idx] = t.scale
            elif isinstance(t, ImageTex):
                ttype[idx] = TEX_IMAGE
                image_id[idx] = self._img_index[id(t.data)]
            else:
                raise TypeError(t)
        leaves.update({
            "textures.ttype": i32(ttype), "textures.color": flt(color),
            "textures.color2": flt(color2), "textures.scale": flt(scale),
            "textures.image_id": i32(image_id),
        })

        # image atlas, padded to common dims
        if self._images:
            hmax = max(im.shape[0] for im in self._images)
            wmax = max(im.shape[1] for im in self._images)
            atlas = np.zeros((len(self._images), hmax, wmax, 4), dtype=np.uint8)
            ih = np.zeros(len(self._images), dtype=np.int32)
            iw = np.zeros(len(self._images), dtype=np.int32)
            for idx, im in enumerate(self._images):
                atlas[idx, : im.shape[0], : im.shape[1]] = im
                ih[idx], iw[idx] = im.shape[0], im.shape[1]
        else:
            atlas = np.zeros((1, 1, 1, 4), dtype=np.uint8)
            ih = np.ones(1, dtype=np.int32)
            iw = np.ones(1, dtype=np.int32)

        # kernel-layout packed texels (see Scene.images_packed)
        flats = []
        base = np.zeros(max(1, len(self._images)), dtype=np.int32)
        off = 0
        for idx, im in enumerate(self._images):
            u32 = im.astype(np.uint32)
            packed = (
                u32[..., 0] | (u32[..., 1] << 8) | (u32[..., 2] << 16)
                | (u32[..., 3] << 24)
            ).reshape(-1)
            base[idx] = off
            off += packed.size
            flats.append(packed)
        flat = np.concatenate(flats) if flats else np.zeros(1, dtype=np.uint32)
        flat = np.concatenate([flat, np.zeros((-flat.size) % 128, dtype=np.uint32)])

        grad, px, py, pz = perlin_mod.make_tables(self.perlin_seed, dtype)
        leaves.update({
            "perlin_grad": grad, "perlin_px": px, "perlin_py": py,
            "perlin_pz": pz, "images": atlas, "image_h": ih, "image_w": iw,
            "images_packed": flat.view(np.int32).reshape(-1, 128),
            "image_base": base,
        })
        meta = dict(
            n_spheres=ns,
            n_rects=nr,
            has_checker=any(isinstance(t, Checker) for t in tex_descs),
            has_noise=any(isinstance(t, Noise) for t in tex_descs),
            has_image=any(isinstance(t, ImageTex) for t in tex_descs),
            has_motion=any(tuple(s[0]) != tuple(s[1]) for s in self._spheres),
        )
        return leaves, meta

    def build(self, device, dtype=torch.float32) -> Scene:
        """Freeze on the host in `dtype` (torch.float32 or torch.float64),
        then move every array to `device` once."""
        leaves, meta = self.build_numpy(numpy_dtype(dtype))
        return scene_from_leaves(leaves, meta, device)


def numpy_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy float type of a torch float type."""
    return np.dtype(str(dtype).removeprefix("torch."))


def scene_from_leaves(leaves: dict, meta: dict, device) -> Scene:
    """Scene on `device` from host leaves keyed as build_numpy keys them."""
    want = {f"{g}.{f.name}" for g, cls in LEAF_GROUPS.items()
            for f in dataclasses.fields(cls)} | set(TOP_LEAVES)
    if set(leaves) != want:
        raise KeyError(
            f"scene leaves mismatch: missing {sorted(want - set(leaves))}, "
            f"unexpected {sorted(set(leaves) - want)}"
        )
    # np.array copies: leaves may be read-only views of another framework's buffers
    t = {k: torch.as_tensor(np.array(v), device=device) for k, v in leaves.items()}
    groups = {
        g: cls(**{f.name: t[f"{g}.{f.name}"] for f in dataclasses.fields(cls)})
        for g, cls in LEAF_GROUPS.items()
    }
    return Scene(**groups, **{k: t[k] for k in TOP_LEAVES}, **meta)
