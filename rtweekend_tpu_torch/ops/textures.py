"""Branchless texture evaluation (rtweekend_tpu.ops.textures), shared by
the eager integrator and the differentiable replay (ops/replay.py).

Every texture family the scene holds is evaluated for every lane and
selected by type id (the reference's Texture dispatch,
texture.zig:36-43); families the scene lacks are skipped by its has_*
flags.
"""

from __future__ import annotations

import dataclasses

import torch

from rtweekend_tpu_torch.models.scene import TEX_CHECKER, TEX_IMAGE, TEX_NOISE, Scene
from rtweekend_tpu_torch.ops.intersect import gather
from rtweekend_tpu_torch.utils import perlin as perlin_mod


@dataclasses.dataclass
class TextureRows:
    """The texture of each ray's hit, one row a ray: gathered from the
    scene's texture table (texture_rows) or sliced from the replay's packed
    winner rows. A field of a family the scene lacks may be None."""
    ttype: torch.Tensor     # [N] int texture type
    color: torch.Tensor     # [N, 3] solid color, checker even
    color2: torch.Tensor    # [N, 3] checker odd
    scale: torch.Tensor     # [N] noise scale
    image_id: torch.Tensor  # [N] int


def texture_rows(scene: Scene, tex_id) -> TextureRows:
    """The rows of texture `tex_id` [N] that the scene's families read."""
    tx = scene.textures
    tid = tex_id.long()
    return TextureRows(
        ttype=tx.ttype[tid], color=gather(tx.color, tid),
        color2=gather(tx.color2, tid) if scene.has_checker else None,
        scale=gather(tx.scale, tid) if scene.has_noise else None,
        image_id=tx.image_id[tid] if scene.has_image else None,
    )


def shade(scene: Scene, tex: TextureRows, u, v, p):
    """Color [N, 3] of the textures `tex` at surface coords u, v [N] and
    point p [N, 3]; u and v are read only if the scene has images."""
    out = tex.color                               # solid (texture.zig:46-55)

    if scene.has_checker:
        # odd where sin(10x) sin(10y) sin(10z) < 0 (texture.zig:78-82)
        sines = torch.sin(10.0 * p[:, 0]) * torch.sin(10.0 * p[:, 1]) * torch.sin(10.0 * p[:, 2])
        checker = torch.where((sines < 0.0)[:, None], tex.color2, tex.color)
        out = torch.where((tex.ttype == TEX_CHECKER)[:, None], checker, out)

    if scene.has_noise:
        # 0.5 (1 + sin(scale z + 10 turb(p, 7))), grey (texture.zig:100-104)
        turbv = perlin_mod.turb(scene.perlin_grad, scene.perlin_px, scene.perlin_py,
                                scene.perlin_pz, p, depth=7)
        gray = 0.5 * (1.0 + torch.sin(tex.scale * p[:, 2] + 10.0 * turbv))
        out = torch.where((tex.ttype == TEX_NOISE)[:, None], gray[:, None], out)

    if scene.has_image:
        # nearest texel (texture.zig:120-144) with j clamped to height - 1
        # (the reference clamps it to width - 1), and the alpha == 0 ->
        # ocean-blue rule (texture.zig:138-140)
        img_id = tex.image_id.long()
        iw, ih = scene.image_w[img_id], scene.image_h[img_id]
        uu = torch.clamp(u, 0.0, 1.0)
        vv = 1.0 - torch.clamp(v, 0.0, 1.0)
        i = torch.minimum((uu * iw.to(u.dtype)).to(torch.int32), iw - 1)
        j = torch.minimum((vv * ih.to(u.dtype)).to(torch.int32), ih - 1)
        texel = scene.images[img_id, j.long(), i.long()].to(u.dtype)
        ocean = torch.tensor([0.0, 0.0, 1.0], dtype=u.dtype, device=u.device)
        img_col = torch.where((texel[:, 3] == 0.0)[:, None], ocean, texel[:, :3] / 255.0)
        out = torch.where((tex.ttype == TEX_IMAGE)[:, None], img_col, out)

    return out


def texture_value(scene: Scene, tex_id, u, v, p):
    """Color of texture `tex_id` [N] at surface coords u, v [N] and point
    p [N, 3]: [N, 3]."""
    return shade(scene, texture_rows(scene, tex_id), u, v, p)
