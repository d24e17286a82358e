"""The (tiles, samples) layout of the ranks (rtweekend_tpu.parallel.mesh).

A path tracer has two axes that need no communication while rays bounce:
pixel tiles and sample batches. The ranks of the default process group
form a 2-D `DeviceMesh` over them; scene parameters are replicated on
every rank, and what crosses ranks is the framebuffer and the gradients
(parallel/shard.py). A rank's part is its coordinate on the mesh,
`mesh.get_coordinate()` = (tile, sample).
"""

from __future__ import annotations

from typing import Optional, Tuple

from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from rtweekend_tpu_torch.device import resolve_device

TILE_AXIS = "tiles"
SAMPLE_AXIS = "samples"


def make_mesh(shape: Optional[Tuple[int, int]] = None, *, device=None) -> DeviceMesh:
    """Mesh over (tiles, samples) of every rank of the default process
    group, which must be initialized (parallel/multihost.initialize).
    Default: all ranks on the tile axis. device: the ranks' device type,
    the card unless the caller asks for the CPU (device.resolve_device)."""
    import torch.distributed as dist

    n = dist.get_world_size()
    if shape is None:
        shape = (n, 1)
    if len(shape) != 2 or shape[0] * shape[1] != n:
        raise ValueError(f"mesh shape {tuple(shape)} != {n} ranks")
    return init_device_mesh(resolve_device(device).type, tuple(shape),
                            mesh_dim_names=(TILE_AXIS, SAMPLE_AXIS))
