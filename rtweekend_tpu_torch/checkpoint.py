"""Checkpoint and resume of render accumulation (rtweekend_tpu.checkpoint).

The radiance-sum framebuffer and the count of samples done are the whole
state of a render: counter-keyed sampling makes sample k of a pixel the
same whatever ran before it, so a resumed render continues the exact
sample sequence. The file is the JAX package's: an .npz with `accum`,
`samples_done` and a JSON `meta` fingerprint, so a checkpoint written by
either package resumes in the other.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Optional

import numpy as np
import torch

from rtweekend_tpu_torch.render import (
    _Tracer,
    _capacities_for,
    batch_size,
    resolve_kernel,
    to_framebuffer,
)


@dataclasses.dataclass
class RenderState:
    accum: np.ndarray          # radiance sums [H, W, 3]
    samples_done: int
    meta: dict                 # configuration fingerprint


def _meta(scene_name, width, height, spp, max_depth, seed) -> dict:
    return dict(scene=scene_name, width=width, height=height, samples_per_pixel=spp,
                max_depth=max_depth, seed=seed, version=1)


def save(path: str, state: RenderState) -> None:
    """Atomic save: a temporary file in the same directory, then a rename,
    so an interruption mid-save leaves the previous checkpoint intact."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".ckpt.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, accum=np.asarray(state.accum),
                     samples_done=np.int64(state.samples_done),
                     meta=json.dumps(state.meta))
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load(path: str) -> Optional[RenderState]:
    if not os.path.exists(path):
        return None
    with np.load(path, allow_pickle=False) as z:
        return RenderState(accum=z["accum"], samples_done=int(z["samples_done"]),
                           meta=json.loads(str(z["meta"])))


@torch.no_grad()
def render_resumable(scene, camera, scene_name: str, width: int, height: int,
                     samples_per_pixel: int, max_depth: int, background, seed: int,
                     checkpoint_path: str, *, checkpoint_every: int = 4,
                     rays_per_chunk: int = 1 << 20, kernel: str = "auto",
                     progress: bool = False):
    """render.render() with a checkpoint every `checkpoint_every` sample
    batches, resuming from `checkpoint_path` when its fingerprint matches
    (a checkpoint of another configuration is ignored and overwritten).

    The tracer is render()'s: on the kernel path the compacted driver with
    the static schedule, and the overflowed batches are re-traced before
    each save (whose device-to-host copy waits for the device anyway), so
    a saved checkpoint never holds dropped rays. Returns the radiance-sum
    framebuffer [H, W, 3] in the scene's dtype."""
    dtype = scene.spheres.c0.dtype
    kernel = resolve_kernel(kernel, dtype)
    meta = _meta(scene_name, width, height, samples_per_pixel, max_depth, seed)
    state = load(checkpoint_path)
    if state is not None and state.meta != meta:
        state = None  # configuration changed: restart
    done = state.samples_done if state else 0
    if state:
        accum = torch.as_tensor(state.accum, dtype=dtype).to(scene.device)
    else:
        accum = torch.zeros((height, width, 3), dtype=dtype, device=scene.device)
    sums = accum.flip(0).reshape(width * height, 3)   # the tracer's pixel-id order

    seed = int(seed) & 0xFFFFFFFF
    batch = batch_size(width * height, samples_per_pixel, rays_per_chunk)
    tracer = _Tracer(scene, camera, width, height, max_depth, background, seed, kernel,
                     _capacities_for(background))
    i = 0
    while done < samples_per_pixel:
        n = min(batch, samples_per_pixel - done)
        sums = tracer.batch(done, n, sums)
        done += n
        i += 1
        if i % checkpoint_every == 0 and done < samples_per_pixel:
            sums = tracer.recover(sums)
            save(checkpoint_path, RenderState(
                to_framebuffer(sums, width, height).cpu().numpy(), done, meta))
        if progress:
            print(f"\rsamples: {done}/{samples_per_pixel}   ", end="", flush=True)
    if progress:
        print()
    accum = to_framebuffer(tracer.recover(sums), width, height)
    save(checkpoint_path, RenderState(accum.cpu().numpy(), done, meta))
    return accum
