"""Render driver: sample-batched accumulation into a framebuffer.

The reference's rows/cols/samples loop (reference src/main.zig:382-402)
becomes: generate every pixel's rays for a batch of samples at once,
trace them as one wavefront through the compacted bounce driver, and add
the per-pixel radiance sums into a framebuffer on the device. Nothing is
read back to the host until the end of the render, where the overflow
flags of all batches are read once and any overflowed batch is traced
again uncompacted (`_recover_overflows`).
"""

from __future__ import annotations

import numpy as np
import torch

from rtweekend_tpu_torch.config import (
    FOCUS_DIST,
    SCENE_DEFAULTS,
    TIME0,
    TIME1,
    VUP,
    RenderConfig,
)
from rtweekend_tpu_torch.device import resolve_device
from rtweekend_tpu_torch.models.builders import build_scene
from rtweekend_tpu_torch.models.scene import Scene
from rtweekend_tpu_torch.ops.camera import Camera, generate_rays, make_camera
from rtweekend_tpu_torch.ops.cuda.megakernel import (
    CAPS_CLOSED,
    CAPS_OPEN,
    Tables,
    pack_scene,
    trace_paths,
    trace_paths_compact,
)
from rtweekend_tpu_torch.utils import image as image_mod


def _gen_batch_rays(camera: Camera, seed: int, sample_start: int, *,
                    width: int, height: int, n_samples: int):
    dev = camera.origin.device
    n_pix = width * height
    pixel_ids = torch.arange(n_pix, dtype=torch.int32, device=dev).repeat_interleave(
        n_samples
    )
    sample_ids = sample_start + torch.arange(
        n_samples, dtype=torch.int32, device=dev
    ).repeat(n_pix)
    o, d, t = generate_rays(camera, width, height, pixel_ids, sample_ids, seed)
    return o, d, t, pixel_ids, sample_ids


def _accum_batch(accum, radiance, *, width: int, height: int, n_samples: int):
    """accum [H, W, 3] += per-pixel sums; row 0 is the image TOP (the
    reference flips at store, main.zig:396). Updates accum in place."""
    sums = radiance.reshape(width * height, n_samples, 3).sum(dim=1)
    accum += sums.reshape(height, width, 3).flip(0)
    return accum


def _capacities_for(background):
    """Static compaction schedule from the (host-side) background: a lit
    background means rays escape and die fast (open scenes); a black one
    means an enclosed emissive scene where most rays stay alive."""
    return CAPS_OPEN if float(np.max(background)) > 0.0 else CAPS_CLOSED


def render_batch_compact(tables: Tables, camera, background, seed, sample_start,
                         accum, *, width, height, n_samples, max_depth,
                         capacities, kernel="auto"):
    """One sample batch through the compacted driver. Returns (accum,
    overflow flag); the flag stays on the device."""
    o, d, t, pixel_ids, sample_ids = _gen_batch_rays(
        camera, seed, sample_start, width=width, height=height, n_samples=n_samples
    )
    radiance, overflow = trace_paths_compact(
        tables, o, d, t, pixel_ids, sample_ids, seed, background, max_depth,
        capacities=capacities, kernel=kernel,
    )
    accum = _accum_batch(accum, radiance, width=width, height=height,
                         n_samples=n_samples)
    return accum, overflow


def render_batch(tables: Tables, camera, background, seed, sample_start, accum, *,
                 width, height, n_samples, max_depth, kernel="auto"):
    """One sample batch, all bounces in one launch, no compaction."""
    o, d, t, pixel_ids, sample_ids = _gen_batch_rays(
        camera, seed, sample_start, width=width, height=height, n_samples=n_samples
    )
    radiance = trace_paths(tables, o, d, t, pixel_ids, sample_ids, seed,
                           background, max_depth, kernel=kernel)
    return _accum_batch(accum, radiance, width=width, height=height,
                        n_samples=n_samples)


def render(scene: Scene, camera: Camera, width: int, height: int,
           samples_per_pixel: int, max_depth: int, background, seed: int, *,
           rays_per_chunk: int = 1 << 20, kernel: str = "auto", capacities=None,
           progress: bool = False):
    """Full render on the scene's device; returns the radiance SUM
    framebuffer [H, W, 3] (divide by spp / tone map downstream).

    background is a host value: 3 floats (flat sky) or a (bottom, top)
    pair (the gradient sky, lerped by ray elevation). capacities overrides the
    compaction schedule (sequence of (bounce, fraction); () disables
    compaction); by default it follows the background. kernel: "auto"
    (the CUDA kernel for a scene on the card, the plain version on the
    CPU), "cuda", or "torch" (the plain version)."""
    if capacities is None:
        capacities = _capacities_for(background)
    seed = int(seed) & 0xFFFFFFFF
    tables = pack_scene(scene)
    n_pix = width * height
    batch = max(1, min(samples_per_pixel, rays_per_chunk // n_pix))
    while batch > 1 and samples_per_pixel % batch:
        batch -= 1
    accum = torch.zeros((height, width, 3), dtype=torch.float32, device=scene.device)
    overflows = []  # [(sample_start, n_samples, device flag)]
    done = 0
    while done < samples_per_pixel:
        n = min(batch, samples_per_pixel - done)
        accum, ovf = render_batch_compact(
            tables, camera, background, seed, done, accum, width=width,
            height=height, n_samples=n, max_depth=max_depth,
            capacities=capacities, kernel=kernel,
        )
        overflows.append((done, n, ovf))
        done += n
        if progress:
            print(f"\rsamples: {done}/{samples_per_pixel}   ", end="", flush=True)
    if progress:
        print()
    return _recover_overflows(
        accum, overflows, tables, camera, background, seed, width=width,
        height=height, max_depth=max_depth, capacities=capacities, kernel=kernel,
    )


def _recover_overflows(accum, overflows, tables, camera, background, seed, *,
                       width, height, max_depth, capacities, kernel):
    """Re-trace every batch whose compaction capacity overflowed. The
    flags are read once, here; for a bad batch the compacted contribution
    (deterministic, counter-keyed) is subtracted and the batch traced
    again without compaction, which never drops rays."""
    if not overflows:
        return accum
    flags = torch.stack([f for _, _, f in overflows]).cpu()
    for (start, n, _), bad in zip(overflows, flags.tolist()):
        if not bad:
            continue
        kw = dict(width=width, height=height, n_samples=n, max_depth=max_depth,
                  kernel=kernel)
        wrong, _ = render_batch_compact(
            tables, camera, background, seed, start, torch.zeros_like(accum),
            capacities=capacities, **kw,
        )
        good = render_batch(tables, camera, background, seed, start,
                            torch.zeros_like(accum), **kw)
        accum = accum - wrong + good
    return accum


def camera_for_scene(name: str, aspect_ratio=None, device=None) -> Camera:
    p = SCENE_DEFAULTS[name]
    aspect = aspect_ratio if aspect_ratio is not None else p["width"] / p["height"]
    return make_camera(
        p["look_from"], p["look_at"], VUP, p["vfov"], aspect, p["aperture"],
        p.get("focus_dist", FOCUS_DIST), TIME0, TIME1,
        device=resolve_device(device),
    )


def render_image(config: RenderConfig, *, device=None, kernel: str = "auto",
                 capacities=None, progress: bool = False):
    """End to end: build scene and camera from config on `device` (default:
    the card), render, tone map. Returns (uint8 image [H, W, 3] numpy,
    radiance-sum framebuffer tensor)."""
    dev = resolve_device(device)
    scene = build_scene(config.scene, seed=config.seed, device=dev)
    camera = camera_for_scene(config.scene, config.width / config.height, dev)
    accum = render(
        scene, camera, config.width, config.height, config.samples_per_pixel,
        config.max_depth, SCENE_DEFAULTS[config.scene]["background"], config.seed,
        rays_per_chunk=config.rays_per_chunk, kernel=kernel,
        capacities=capacities, progress=progress,
    )
    img = image_mod.tonemap(accum, config.samples_per_pixel)
    return img.cpu().numpy(), accum
