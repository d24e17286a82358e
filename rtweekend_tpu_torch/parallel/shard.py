"""Inverse-rendering train step with streamed winner blocks
(rtweekend_tpu.parallel.shard, one device).

`sharded_train_step` is the JAX package's `_train_step_pallas_streaming`
(shard.py:413-495) on one device:

- pass 1: the bounce kernel's radiance, summed per pixel over sample
  blocks of at most `rays_per_chunk` rays, gives the spp-mean image, the
  MSE loss against the target and its cotangent 2 err / (n_pix * 3);
- pass 2: per sample block, the kernel's per-bounce winners feed the
  differentiable replay, and torch.autograd.grad of
  <cotangent, block replay sums / spp> is accumulated. The block
  gradients sum to the full gradient because the mean image is linear in
  the blocks, so only one block's winners [max_depth, n_pix * block]
  exist at a time.

Then one SGD step. The JAX package's mesh (tiles x samples, psum'd
grads) waits for ROADMAP Queue 1 #11, its eager-integrator branch
(use_pallas=False) for Queue 1 #8.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from rtweekend_tpu_torch.models.scene import Scene
from rtweekend_tpu_torch.ops.camera import Camera, generate_rays
from rtweekend_tpu_torch.ops.cuda.megakernel import pack_scene, trace_paths
from rtweekend_tpu_torch.ops.cuda.vjp import host_background
from rtweekend_tpu_torch.ops.replay import trace_paths_replay_fast


def extract_params(scene: Scene):
    """The differentiable parameter set: sphere centers and radii,
    texture colors (albedo), metal fuzz, dielectric ior."""
    return {
        "c0": scene.spheres.c0,
        "radius": scene.spheres.radius,
        "color": scene.textures.color,
        "fuzz": scene.materials.fuzz,
        "ior": scene.materials.ior,
    }


def merge_params(scene: Scene, params) -> Scene:
    return dataclasses.replace(
        scene,
        spheres=dataclasses.replace(scene.spheres, c0=params["c0"], radius=params["radius"]),
        textures=dataclasses.replace(scene.textures, color=params["color"]),
        materials=dataclasses.replace(scene.materials, fuzz=params["fuzz"], ior=params["ior"]),
    )


def _cross_ids(pixel_ids, sample_ids):
    """Every (pixel, sample) pair, pixel-major."""
    pids = pixel_ids.repeat_interleave(sample_ids.shape[0])
    sids = sample_ids.repeat(pixel_ids.shape[0])
    return pids, sids


def _pick_sample_chunk(n_pix, n_smp, rays_per_chunk):
    """Largest sample count dividing n_smp with n_pix * chunk rays within
    rays_per_chunk (at least 1)."""
    chunk = max(1, min(n_smp, rays_per_chunk // max(n_pix, 1)))
    while chunk > 1 and n_smp % chunk:
        chunk -= 1
    return chunk


def _sample_blocks(camera, width, height, samples_per_pixel, seed, rays_per_chunk, dev):
    """(block size, block starts, block_rays): block_rays(s0) makes the
    rays (origins, dirs, times, pixel_ids, sample_ids) of every pixel with
    samples s0 .. s0 + blk - 1, pixel-major."""
    pixel_ids = torch.arange(width * height, dtype=torch.int32, device=dev)
    sample_ids = torch.arange(samples_per_pixel, dtype=torch.int32, device=dev)
    blk = _pick_sample_chunk(width * height, samples_per_pixel, rays_per_chunk)

    def block_rays(s0):
        pids, sids = _cross_ids(pixel_ids, sample_ids[s0:s0 + blk])
        return (*generate_rays(camera, width, height, pids, sids, seed), pids, sids)

    return blk, range(0, samples_per_pixel, blk), block_rays


@torch.no_grad()
def kernel_mean_image(scene: Scene, camera: Camera, width: int, height: int,
                      samples_per_pixel: int, max_depth: int, background, seed: int, *,
                      kernel: str = "auto", rays_per_chunk: int = 1 << 20):
    """The spp-mean radiance [H, W, 3] (row 0 = top) from the bounce
    kernel's own radiance, one launch per sample block of at most
    `rays_per_chunk` rays: pass 1 of the train step."""
    seed = int(seed) & 0xFFFFFFFF
    dev = scene.device
    n_pix = width * height
    blk, starts, block_rays = _sample_blocks(camera, width, height, samples_per_pixel,
                                             seed, rays_per_chunk, dev)
    tables = pack_scene(scene)
    sums = torch.zeros((n_pix, 3), dtype=torch.float32, device=dev)
    for s0 in starts:
        rad = trace_paths(tables, *block_rays(s0), seed, host_background(background), max_depth,
                          kernel=kernel)
        sums += rad.reshape(n_pix, blk, 3).sum(dim=1)
    return torch.flip((sums / samples_per_pixel).reshape(height, width, 3), [0])


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def sharded_train_step(scene: Scene, camera: Camera, target, width: int, height: int,
                       samples_per_pixel: int, max_depth: int, background, seed: int,
                       mesh=None, lr: float = 0.01, *, kernel: str = "auto",
                       rays_per_chunk: int = 1 << 20, use_pallas: bool = True,
                       timings: dict | None = None):
    """One SGD step of inverse rendering on the scene's device. Returns
    (new params dict, loss as a 0-d tensor on the device).

    target [H, W, 3] is the mean-radiance image in framebuffer orientation
    (row 0 = top); it is flipped to pixel-id order (bottom-up rows,
    main.zig:396). The loss is MSE between the spp-mean radiance and the
    target. Gradients equal the full-buffer gradients up to the
    kernel-vs-replay reassociation in the cotangent (the residual is
    taken at the kernel's mean image).

    kernel: "auto", "cuda" or "torch", as in render(). use_pallas=False
    (the JAX package's eager integrator) is not ported. If `timings` is a
    dict, the device is synchronized between phases and it receives the
    seconds of pass 1 (`pass1_s`), of the winners launches (`winners_s`)
    and of the replay forward + backward (`replay_s`)."""
    if mesh is not None:
        raise NotImplementedError(
            "multi-device train step: ROADMAP Queue 1 #11 (pass mesh=None)")
    if not use_pallas:
        raise NotImplementedError(
            "use_pallas=False needs the eager integrator: ROADMAP Queue 1 #8")
    dev = scene.device
    seed = int(seed) & 0xFFFFFFFF
    n_pix = width * height

    def flat(img):  # framebuffer orientation -> pixel-id order
        return torch.flip(img, [0]).reshape(n_pix, 3)

    target_flat = flat(torch.as_tensor(target, dtype=torch.float32, device=dev))
    params = {k: v.detach().requires_grad_(True) for k, v in extract_params(scene).items()}
    clock = {"pass1_s": 0.0, "winners_s": 0.0, "replay_s": 0.0}

    def tick(key, t0):
        if timings is not None:
            _sync(dev)
            clock[key] += time.perf_counter() - t0
        return time.perf_counter()

    if timings is not None:
        _sync(dev)
    t0 = time.perf_counter()
    # ---- pass 1: loss and cotangent from the kernel's own radiance ----
    mean = flat(kernel_mean_image(scene, camera, width, height, samples_per_pixel,
                                  max_depth, background, seed, kernel=kernel,
                                  rays_per_chunk=rays_per_chunk))
    err = mean - target_flat
    loss = torch.sum(err * err) / (n_pix * 3)
    cot = 2.0 * err / (n_pix * 3)
    t0 = tick("pass1_s", t0)

    # ---- pass 2: per block, kernel winners, then the replay's VJP ----
    blk, starts, block_rays = _sample_blocks(camera, width, height, samples_per_pixel,
                                             seed, rays_per_chunk, dev)
    with torch.no_grad():
        tables = pack_scene(scene)
    grads = {k: torch.zeros_like(v) for k, v in params.items()}
    for s0 in starts:
        with torch.no_grad():
            o, d, t, pids, sids = block_rays(s0)
            _, win = trace_paths(tables, o, d, t, pids, sids, seed,
                                 host_background(background), max_depth, kernel=kernel,
                                 return_winners=True)
        t0 = tick("winners_s", t0)
        rad = trace_paths_replay_fast(merge_params(scene, params), o, d, t, pids, sids,
                                      seed, background, win)
        mean_c = rad.reshape(n_pix, blk, 3).sum(dim=1) / samples_per_pixel
        g = torch.autograd.grad(torch.sum(cot * mean_c), list(params.values()))
        for k, gk in zip(params, g):
            grads[k] += gk
        t0 = tick("replay_s", t0)

    if timings is not None:
        timings.update(clock)
    new_params = {k: (params[k] - lr * grads[k]).detach() for k in params}
    return new_params, loss
