"""Differentiable tracing: the bounce kernel decides the paths, the replay
differentiates them (rtweekend_tpu/ops/pallas/vjp.py).

The kernel is forward only. With want_winners it emits, besides the
radiance, the closest-hit primitive of every bounce — all the discrete
decisions of the paths. `trace_paths_replay_fast` then re-traces those
paths with plain tensor ops, and its output is what this function
returns: an ordinary differentiable function under PyTorch autograd,
with no custom autograd.Function and no backward kernel. The gradient
is the detached-sampling estimator of rtweekend_tpu_torch/grad.py.
"""

from __future__ import annotations

import torch

from rtweekend_tpu_torch.models.scene import Scene
from rtweekend_tpu_torch.ops.coeffs import T_MIN
from rtweekend_tpu_torch.ops.cuda.megakernel import pack_scene, trace_paths
from rtweekend_tpu_torch.ops.replay import trace_paths_replay_fast


def host_background(background):
    """The background as host floats for the kernel (3 floats; a [2, 3]
    gradient sky is refused by the kernel wrapper)."""
    if isinstance(background, torch.Tensor):
        return background.detach().cpu().tolist()
    return background


@torch.no_grad()
def kernel_winners(scene: Scene, origins, dirs, times, pixel_ids, sample_ids,
                   seed: int, background, max_depth: int, *, t_min: float = T_MIN,
                   kernel: str = "auto"):
    """(radiance [N, 3], winners [max_depth, N]) from the bounce kernel.
    Tables and launch run under no_grad, so no graph reaches the kernel
    (the JAX package applies stop_gradient to every kernel input,
    vjp.py:67-76); the winners carry no gradient by definition."""
    tables = pack_scene(scene)
    return trace_paths(
        tables, origins, dirs, times, pixel_ids, sample_ids, seed,
        host_background(background), max_depth, kernel=kernel, return_winners=True, t_min=t_min,
    )


def trace_paths_fast(scene: Scene, origins, dirs, times, pixel_ids, sample_ids,
                     seed: int, background, max_depth: int, t_min: float = T_MIN,
                     *, kernel: str = "auto"):
    """Differentiable radiance [N, 3]: kernel winners, then the replay on
    the live scene. kernel: "auto" (the CUDA kernel for tensors on the
    card, the plain version on the CPU), "cuda" or "torch" (the plain
    version), as in render()."""
    _, winners = kernel_winners(scene, origins, dirs, times, pixel_ids, sample_ids,
                                seed, background, max_depth, t_min=t_min,
                                kernel=kernel)
    return trace_paths_replay_fast(
        scene, origins, dirs, times, pixel_ids, sample_ids, seed, background,
        winners, t_min=t_min, remat=True,
    )
