"""Carry a scene across from the JAX package.

`scene_from_numpy` takes the leaves of an `rtweekend_tpu` Scene,
flattened to numpy by the caller and keyed "group.field" (e.g.
"spheres.c0") or "field" for the top-level arrays (e.g. "perlin_px"),
and returns the port's Scene. The static metadata the JAX pytree keeps
outside its leaves is recomputed from the leaves themselves.
"""

from __future__ import annotations

import numpy as np

from rtweekend_tpu_torch.device import resolve_device
from rtweekend_tpu_torch.models.scene import (
    TEX_CHECKER,
    TEX_IMAGE,
    TEX_NOISE,
    Scene,
    scene_from_leaves,
)


def scene_from_numpy(leaves: dict, device=None) -> Scene:
    """The port's Scene from JAX-side leaves (see the module docstring)."""
    leaves = {k: np.asarray(v) for k, v in leaves.items()}
    s_act = leaves["spheres.active"].astype(bool)
    ttype = leaves["textures.ttype"]
    meta = dict(
        n_spheres=int(s_act.sum()),
        n_rects=int(leaves["rects.active"].astype(bool).sum()),
        has_checker=bool((ttype == TEX_CHECKER).any()),
        has_noise=bool((ttype == TEX_NOISE).any()),
        has_image=bool((ttype == TEX_IMAGE).any()),
        has_motion=bool((leaves["spheres.dc"][s_act] != 0).any()),
    )
    return scene_from_leaves(leaves, meta, resolve_device(device))

