"""Inverse rendering with the plain tracer: the mean image of a scene, and
one SGD step on the MSE between a scene's mean image and a target.

The step is the program's estimator computed again: pass 1 traces every
ray without gradient for the loss and its cotangent 2 err / (n_pix * 3);
pass 2 traces the same rays, block by block, with the parameters
requiring grad (reference.tracer's detached estimator) and takes the
gradient of <cotangent, block mean>. The block gradients add up to the
whole image's, since the mean image is linear in the blocks.
"""

from __future__ import annotations

import torch

from benchmark.reference import camera
from benchmark.reference.tracer import PARAMS, trace


def _pixel_blocks(n_pix: int, spp: int, block_rays: int, device):
    """Pixel-range blocks of all samples: (p0, p1, pixel ids, sample ids)."""
    step = max(1, block_rays // spp)
    for p0 in range(0, n_pix, step):
        p1 = min(n_pix, p0 + step)
        pid = torch.arange(p0, p1, dtype=torch.int32, device=device).repeat_interleave(spp)
        sid = torch.arange(spp, dtype=torch.int32, device=device).repeat(p1 - p0)
        yield p0, p1, pid, sid


@torch.no_grad()
def mean_image(sc, cam, width, height, spp, max_depth, background, seed, *,
               params=None, march="fp32", block_rays=1 << 18, record=None):
    """Mean radiance [n_pix, 3] in pixel-id order (rows from the bottom).
    record, if a list, gains each block's winners (tracer.trace)."""
    n_pix = width * height
    dev = sc["c0"].device
    out = torch.zeros((n_pix, 3), device=dev)
    for p0, p1, pid, sid in _pixel_blocks(n_pix, spp, block_rays, dev):
        o, d, t = camera.rays(cam, width, height, pid, sid, seed)
        win = None if record is None else []
        rad = trace(sc, o, d, t, pid, sid, seed, background, max_depth, march=march,
                    params=params, record=win)
        if record is not None:
            record.append(win)
        out[p0:p1] = rad.reshape(p1 - p0, spp, 3).sum(1) / spp
    return out


def step(sc, params, cam, target, width, height, spp, max_depth, background, seed, lr, *,
         march="fp32", block_rays=1 << 18):
    """(new parameters, loss, gradients) of one SGD step from `params`
    (dict of PARAMS) towards target [n_pix, 3] (pixel-id order)."""
    n_pix = width * height
    paths = []
    mean = mean_image(sc, cam, width, height, spp, max_depth, background, seed,
                      params=params, march=march, block_rays=block_rays, record=paths)
    err = mean - target
    loss = float((err.double() ** 2).sum() / (n_pix * 3))
    cot = 2.0 * err / (n_pix * 3)
    leaves = {k: params[k].detach().requires_grad_(True) for k in PARAMS}
    grads = {k: torch.zeros_like(v) for k, v in leaves.items()}
    blocks = _pixel_blocks(n_pix, spp, block_rays, sc["c0"].device)
    for (p0, p1, pid, sid), win in zip(blocks, paths):
        o, d, t = camera.rays(cam, width, height, pid, sid, seed)
        rad = trace(sc, o, d, t, pid, sid, seed, background, max_depth, march=march,
                    params=leaves, winners=win)
        blk_mean = rad.reshape(p1 - p0, spp, 3).sum(1) / spp
        g = torch.autograd.grad((cot[p0:p1] * blk_mean).sum(), list(leaves.values()),
                                allow_unused=True, materialize_grads=True)
        for k, gk in zip(leaves, g):
            grads[k] += gk
    new = {k: (params[k] - lr * grads[k]).detach() for k in PARAMS}
    return new, loss, grads
