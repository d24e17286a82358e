"""Starting the ranks of a multi-process run (rtweekend_tpu.parallel.multihost).

One process per rank, on one host or many, every process running the
same program: `initialize` joins the default process group, `global_mesh`
lays all ranks out as (tiles, samples), and `gather_framebuffer` hands a
sharded render's framebuffer to the host. Ranks start either under
`torchrun` (`torchrun --standalone --nproc-per-node N script.py` sets
MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE and LOCAL_RANK; call
`initialize()`), or by hand, every process calling
`initialize("host:port", n, rank)`.

Backends: NCCL between ranks that each have a card of their own; gloo for
ranks on the CPU, and for several ranks that share one card (NCCL refuses
two ranks on one device), whose collectives then pass through the host.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from rtweekend_tpu_torch.device import resolve_device
from rtweekend_tpu_torch.parallel.mesh import make_mesh

BACKENDS = ("nccl", "gloo")


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *,
               backend: Optional[str] = None, device=None) -> torch.device:
    """Join the default process group and return this rank's device.

    Without an address, the rendezvous and the rank come from the
    environment (`env://`: MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE, as
    torchrun sets them); with one, from `tcp://<coordinator_address>`,
    num_processes and process_id. device: the card unless the caller asks
    for the CPU (device.resolve_device; without a card it raises). On a
    card the rank takes card local_rank % device_count (LOCAL_RANK, else
    the rank) and NCCL by default; backend="gloo" lets several ranks share
    one card. On the CPU the backend is gloo."""
    if coordinator_address is None:
        if num_processes is not None or process_id is not None:
            raise ValueError("num_processes and process_id need a coordinator_address "
                             "(without one they come from the environment)")
        init = dict(init_method="env://")
        rank = int(os.environ.get("RANK", "0"))
    else:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator_address needs num_processes and process_id")
        if not 0 <= process_id < num_processes:
            raise ValueError(f"process_id {process_id} not in [0, {num_processes})")
        init = dict(init_method=f"tcp://{coordinator_address}", world_size=num_processes,
                    rank=process_id)
        rank = process_id
    if backend is not None and backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    dev = resolve_device(device)
    if dev.type == "cuda":
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        backend = backend or "nccl"
    elif backend == "nccl":
        raise ValueError("NCCL needs a card; ranks on the CPU use gloo")
    import torch.distributed as dist

    dist.init_process_group(backend or "gloo", **init)
    return dev


def global_mesh(samples_axis: int = 1, *, device=None):
    """(tiles, samples) mesh over every rank of the default group, with
    `samples_axis` ranks on the sample axis: (world // samples_axis,
    samples_axis). device as in mesh.make_mesh."""
    import torch.distributed as dist

    n = dist.get_world_size()
    if samples_axis < 1 or n % samples_axis:
        raise ValueError(f"{n} ranks not divisible by samples={samples_axis}")
    return make_mesh((n // samples_axis, samples_axis), device=device)


def gather_framebuffer(fb) -> np.ndarray:
    """The whole framebuffer as host numpy, on every rank. The port's
    shard.render_sharded already assembles it on every rank with one SUM
    all-reduce (gloo has no all-gather of card tensors), so what is left
    is the copy to the host that JAX's process_allgather makes."""
    return fb.detach().cpu().numpy()
