"""rtweekend_tpu_torch — the PyTorch/CUDA port of the rtweekend_tpu path tracer.

The JAX package `rtweekend_tpu` stays the reference; this package
re-implements its forward render and training path for an NVIDIA H100:
host-side scene builders in float32 or float64, the
counter-RNG thin-lens camera, the bounce megakernel as a hand-written
CUDA kernel (`csrc/megakernel.cu`, with a per-bounce winners variant)
with a plain PyTorch version beside it, wavefront compaction without
host syncs under a measured compaction schedule, the eager integrator
(closest-hit march, textures, scatter as plain tensor ops; the float64
path), resumable checkpointed renders, JSON-lines metrics and profiler
traces, tone map and PNG/PPM output, and the differentiable training
path under PyTorch autograd: the replay of kernel-decided paths or the
eager integrator end to end (`grad.py`, `parallel/shard.py`), on one
device or over a (tiles, samples) mesh of torch.distributed ranks
(`parallel/`: render_sharded and the train step's all-reduced gradients),
and a device-time report of the profiler's traces (`utils/trace_report.py`).
It imports neither `jax` nor `rtweekend_tpu`.

Entry points run on `cuda` unless the caller passes `device="cpu"`.
"""

import torch

# FP32 everywhere, never TF32. TF32 keeps a bf16-class 10-bit mantissa,
# and the closest-hit coefficient rows cancel terms of ~1e6 (the r=1000
# ground sphere's |o-c|^2) down to ~1e3: a reduced-precision product
# flips closest-hit decisions en masse (measured on the JAX side,
# rtweekend_tpu/ops/pallas/megakernel.py:101-118). Set once, here, so
# every matmul the port issues on the card is full fp32.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
