"""Differentiable rendering and inverse rendering (rtweekend_tpu.grad).

Pixel-radiance gradients with respect to sphere centers and radii,
albedo (texture colors), metal fuzz and dielectric ior, by detached
sampling:

- every random draw is a counter hash (utils/rng.py), so no gradient
  flows into sampling;
- discrete events (closest-hit argmin, the Schlick reflect/refract draw,
  metal absorption) carry no gradient: the estimator differentiates the
  smooth integrand along fixed paths (silhouette terms are not
  estimated, the usual detached trade-off);
- kernel "auto", "cuda" or "torch": the bounce kernel decides the paths
  (its winners output) and the replay (ops/replay.py) differentiates
  them, checkpointed per bounce (ops/cuda/vjp.trace_paths_fast);
- kernel "eager": the eager integrator (ops/integrator.trace_paths,
  remat=True) is differentiated end to end, march included, in the
  scene's dtype: the JAX package's use_pallas=False.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from rtweekend_tpu_torch.models.scene import Scene
from rtweekend_tpu_torch.ops import integrator
from rtweekend_tpu_torch.ops.camera import Camera, generate_rays
from rtweekend_tpu_torch.ops.cuda.vjp import trace_paths_fast
from rtweekend_tpu_torch.parallel.shard import extract_params, merge_params
from rtweekend_tpu_torch.render import batch_size, resolve_kernel


def render_mean(scene: Scene, camera: Camera, background, seed: int, *, width: int,
                height: int, spp: int, max_depth: int, kernel: str = "auto",
                rays_per_chunk: int = 1 << 20):
    """Differentiable mean-radiance framebuffer [H, W, 3] (row 0 = top) on
    the scene's device. Samples are traced in chunks of at most
    `rays_per_chunk` rays; autograd keeps each chunk's per-bounce carries
    until the backward pass. kernel: "auto", "cuda" or "torch" (kernel
    winners, then the replay) or "eager" (the eager integrator; "auto"
    picks it for a float64 scene)."""
    kernel = resolve_kernel(kernel, scene.spheres.c0.dtype)
    dev = scene.device
    n_pix = width * height
    chunk = batch_size(n_pix, spp, rays_per_chunk)
    pixel_ids = torch.arange(n_pix, dtype=torch.int32, device=dev).repeat_interleave(chunk)
    sample_base = torch.arange(chunk, dtype=torch.int32, device=dev).repeat(n_pix)
    sums = 0.0
    for s0 in range(0, spp, chunk):
        sample_ids = sample_base + s0
        o, d, t = generate_rays(camera, width, height, pixel_ids, sample_ids, seed)
        if kernel == "eager":
            rad = integrator.trace_paths(scene, o, d, t, pixel_ids, sample_ids, seed,
                                         background, max_depth, remat=True)
        else:
            rad = trace_paths_fast(scene, o, d, t, pixel_ids, sample_ids, seed,
                                   background, max_depth, kernel=kernel)
        sums = sums + rad.reshape(n_pix, chunk, 3).sum(dim=1)
    mean = sums / spp
    return torch.flip(mean.reshape(height, width, 3), [0])


def make_loss(scene: Scene, camera: Camera, target, background, seed: int, *, width: int,
              height: int, spp: int, max_depth: int,
              kernel: str = "auto") -> Callable[[Dict], torch.Tensor]:
    """MSE(mean-radiance render, target) as a function of the parameter
    dict (see parallel.shard.extract_params)."""
    target = torch.as_tensor(target, device=scene.device)

    def loss(params):
        img = render_mean(merge_params(scene, params), camera, background, seed,
                          width=width, height=height, spp=spp, max_depth=max_depth,
                          kernel=kernel)
        return torch.mean((img - target) ** 2)

    return loss


def fit(scene: Scene, camera: Camera, target, background, *, width: int, height: int,
        spp: int, max_depth: int, steps: int = 100, learning_rate: float = 0.05,
        seed: int = 0, param_mask: Optional[Dict[str, bool]] = None,
        verbose: bool = False, kernel: str = "auto") -> Tuple[Scene, list]:
    """Inverse rendering: recover scene parameters from a target image by
    Adam descent through the tracer (torch.optim.Adam with optax.adam's
    defaults: betas 0.9/0.999, eps 1e-8, bias-corrected moments).

    Each step draws a fresh seed (seed * 131071 + i), a new Monte Carlo
    sample of the gradient. `param_mask` restricts which parameter groups
    update (e.g. {"color": True}): the others get a zero gradient.
    Returns (fitted scene, loss history)."""
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in extract_params(scene).items()}
    mask = {k: True for k in params}
    if param_mask is not None:
        mask = {k: param_mask.get(k, False) for k in params}
    opt = torch.optim.Adam(params.values(), lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)

    history = []
    for i in range(steps):
        loss_fn = make_loss(scene, camera, target, background,
                            (seed * 131071 + i) & 0xFFFFFFFF, width=width,
                            height=height, spp=spp, max_depth=max_depth, kernel=kernel)
        opt.zero_grad(set_to_none=False)
        loss = loss_fn(params)
        loss.backward()
        with torch.no_grad():
            for k, p in params.items():
                # a group the graph never reached (the eager path's geometry
                # under a flat sky) gets a zero gradient, as under JAX
                if p.grad is None or not mask[k]:
                    p.grad = torch.zeros_like(p)
        opt.step()
        history.append(float(loss.detach()))
        if verbose and i % 10 == 0:
            print(f"step {i}: loss {history[-1]:.6f}")
    return merge_params(scene, {k: v.detach() for k, v in params.items()}), history
