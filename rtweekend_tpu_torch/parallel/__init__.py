"""Rendering and inverse rendering over a (tiles, samples) mesh of ranks."""

from rtweekend_tpu_torch.parallel.mesh import make_mesh
from rtweekend_tpu_torch.parallel.shard import render_sharded, sharded_train_step

__all__ = ["make_mesh", "render_sharded", "sharded_train_step"]
