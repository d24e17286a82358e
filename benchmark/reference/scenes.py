"""Scene generators of the book-cover scenes, as plain NumPy arrays.

`generateRandomScene` of the reference ray tracer (main.zig:157-221) with
the book's 22x22 grid: a checker ground and motion-blurred diffuse
spheres (`final_scene`), or a gray ground and static spheres
(`golden_scene`). The draw order against `np.random.default_rng(seed)`,
the padding of the sphere table to a multiple of 8, and the tables of
materials and textures (deduplicated by value; metal colours appended as
solid textures after the others) are those of the program's scene
builder, so one seed gives both sides the same scene.
"""

from __future__ import annotations

import numpy as np

MAT_DIFFUSE, MAT_METAL, MAT_DIELECTRIC, MAT_LIGHT = 0, 1, 2, 3
TEX_SOLID, TEX_CHECKER = 0, 1

# (checker ground, moving diffuse spheres) of each scene
SCENES = {"final_scene": (True, True), "golden_scene": (False, False)}


def _pad8(n: int) -> int:
    return max(8, -(-n // 8) * 8)


class _Builder:
    def __init__(self):
        self.textures, self.materials, self.spheres = [], [], []
        self.tex_index, self.mat_index = {}, {}

    def texture(self, desc):
        if desc not in self.tex_index:
            self.tex_index[desc] = len(self.textures)
            self.textures.append(desc)
        return self.tex_index[desc]

    def material(self, desc):
        if desc not in self.mat_index:
            if desc[0] == "diffuse":
                self.texture(desc[1])
            self.mat_index[desc] = len(self.materials)
            self.materials.append(desc)
        return self.mat_index[desc]


def build(name: str, seed: int) -> dict:
    """The scene `name` from `seed` as host arrays (float64; the caller
    rounds to float32): spheres c0, dc, time0, inv_dt, radius, mat_id,
    active; materials mtype, tex_id, fuzz, ior; textures ttype, color,
    color2."""
    checker, motion = SCENES[name]
    rng = np.random.default_rng(seed)
    b = _Builder()
    ground = (("checker", (0.2, 0.3, 0.1), (0.9, 0.9, 0.9)) if checker
              else ("solid", (0.5, 0.5, 0.5)))
    m_ground = b.material(("diffuse", ground))
    m1 = b.material(("dielectric", 1.5))
    m2 = b.material(("diffuse", ("solid", (0.4, 0.2, 0.1))))
    m3 = b.material(("metal", (0.7, 0.6, 0.5), 0.0))
    sph = b.spheres
    sph.append(((0.0, -1000.0, 0.0), (0.0, -1000.0, 0.0), 0.0, 1.0, 1000.0, m_ground))
    sph.append(((0.0, 1.0, 0.0), (0.0, 1.0, 0.0), 0.0, 1.0, 1.0, m1))
    sph.append(((-4.0, 1.0, 0.0), (-4.0, 1.0, 0.0), 0.0, 1.0, 1.0, m2))
    sph.append(((4.0, 1.0, 0.0), (4.0, 1.0, 0.0), 0.0, 1.0, 1.0, m3))
    for a in range(-11, 11):
        for bb in range(-11, 11):
            choose = rng.random()
            center = np.array([a + 0.9 * rng.random(), 0.2, bb + 0.9 * rng.random()])
            if np.linalg.norm(center - np.array([4.0, 0.2, 0.0])) <= 0.9:
                continue
            c = tuple(center)
            if choose < 0.8:
                albedo = rng.random(3) * rng.random(3)
                m = b.material(("diffuse", ("solid", tuple(albedo))))
                if motion:
                    c1 = tuple(center + np.array([0.0, rng.uniform(0.0, 0.5), 0.0]))
                    sph.append((c, c1, 0.0, 1.0, 0.2, m))
                else:
                    sph.append((c, c, 0.0, 1.0, 0.2, m))
            elif choose < 0.95:
                albedo = rng.uniform(0.5, 1.0, 3)
                fuzz = rng.uniform(0.0, 0.5)
                sph.append((c, c, 0.0, 1.0, 0.2, b.material(("metal", tuple(albedo), fuzz))))
            else:
                sph.append((c, c, 0.0, 1.0, 0.2, b.material(("dielectric", 1.5))))

    ns, ps = len(sph), _pad8(len(sph))
    c0 = np.zeros((ps, 3)); c1 = np.zeros((ps, 3))
    c0[:, 1] = c1[:, 1] = 1e9
    t0 = np.zeros(ps); t1 = np.ones(ps); rad = np.ones(ps)
    mat = np.zeros(ps, dtype=np.int64); active = np.zeros(ps, dtype=bool)
    for i, (a0, a1, u0, u1, r, m) in enumerate(sph):
        c0[i], c1[i], t0[i], t1[i], rad[i], mat[i], active[i] = a0, a1, u0, u1, r, m, True

    textures = list(b.textures)
    nm = len(b.materials)
    mtype = np.zeros(nm, dtype=np.int64); tex_id = np.zeros(nm, dtype=np.int64)
    fuzz = np.zeros(nm); ior = np.ones(nm)
    for i, desc in enumerate(b.materials):
        if desc[0] == "diffuse":
            mtype[i], tex_id[i] = MAT_DIFFUSE, b.tex_index[desc[1]]
        elif desc[0] == "metal":
            solid = ("solid", tuple(float(x) for x in desc[1]))
            if solid not in b.tex_index:
                b.tex_index[solid] = len(textures)
                textures.append(solid)
            mtype[i], tex_id[i], fuzz[i] = MAT_METAL, b.tex_index[solid], desc[2]
        else:
            mtype[i], ior[i] = MAT_DIELECTRIC, desc[1]
    nt = len(textures)
    ttype = np.zeros(nt, dtype=np.int64)
    color = np.ones((nt, 3)); color2 = np.zeros((nt, 3))
    for i, desc in enumerate(textures):
        if desc[0] == "solid":
            color[i] = desc[1]
        else:
            ttype[i], color[i], color2[i] = TEX_CHECKER, desc[2], desc[1]
    return dict(c0=c0, dc=c1 - c0, time0=t0, inv_dt=1.0 / (t1 - t0), radius=rad, mat_id=mat,
                active=active, n_spheres=ns, mtype=mtype, tex_id=tex_id, fuzz=fuzz, ior=ior,
                ttype=ttype, color=color, color2=color2)
