"""Profiling and observability (rtweekend_tpu.utils.profiling).

Wall-clock phase timers that wait for the device, rays/s accounting, the
per-bounce alive fractions of a wavefront (its occupancy, which sets the
compaction schedule) and optional torch.profiler traces.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Dict, Optional

import torch

from rtweekend_tpu_torch.ops.integrator import path_decisions


def _synchronize(tensors) -> None:
    """Wait for the work that produces `tensors` (a tensor or a sequence of
    tensors) on every CUDA device they live on; CPU work is already done."""
    if isinstance(tensors, torch.Tensor):
        tensors = [tensors]
    for dev in {t.device for t in tensors}:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


@dataclasses.dataclass
class PhaseTimer:
    """Accumulates wall time per named phase; `block_on` (a tensor or a
    sequence of them) is waited for before the phase's clock stops."""

    totals: Dict[str, float] = dataclasses.field(default_factory=dict)
    counts: Dict[str, int] = dataclasses.field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str, block_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                _synchronize(block_on)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> str:
        return "\n".join(
            f"{k}: {self.totals[k]:.3f}s over {self.counts[k]} calls"
            for k in sorted(self.totals, key=self.totals.get, reverse=True))


def rays_per_second(n_primary: int, seconds: float) -> float:
    return n_primary / max(seconds, 1e-12)


def alive_fractions(scene, o, d, times, pixel_ids, sample_ids, seed: int,
                    max_depth: int) -> torch.Tensor:
    """Fraction of rays alive entering each bounce: [max_depth] float32
    (the eager integrator's semantics). It bounds what compaction can
    save and is what adaptive_capacities places its boundaries by."""
    alive, _ = path_decisions(scene, o, d, times, pixel_ids, sample_ids, seed, max_depth)
    return alive.to(torch.float32).mean(dim=1)


@contextlib.contextmanager
def trace(dirname: Optional[str]):
    """torch.profiler trace of the enclosed work, written into `dirname` as
    a Chrome trace (`trace_<time>_<pid>.json`, viewable in Perfetto); the
    card's activity is traced when a card is present. No-op for None."""
    if dirname is None:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(dirname, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    name = f"trace_{time.strftime('%Y%m%d_%H%M%S')}_{os.getpid()}.json"
    prof.export_chrome_trace(os.path.join(dirname, name))


def device_profile(fn, **meta):
    """fn() once under torch.profiler on the card: its wall time (host
    clock, ending in a sync), device busy time (the kernels' self device
    time summed), idle share of the wall, the bounce kernel's share and the
    ten costliest kernels, in a dict beside `meta`. Busy and idle read
    "not measured" when the profiler sees no device activity."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def self_dev_us(ev):
        return getattr(ev, "self_device_time_total", None) or \
            getattr(ev, "self_cuda_time_total", 0)

    # device-side events only: a host op (aten::index_add_) also reports
    # the device time of the kernels it launched
    kern = sorted(((self_dev_us(ev), ev.key) for ev in prof.key_averages()
                   if ev.device_type == torch.autograd.DeviceType.CUDA
                   and self_dev_us(ev) > 0), reverse=True)
    busy_ms = sum(us for us, _ in kern) / 1e3
    if busy_ms == 0:
        return dict(**meta, wall_ms=wall * 1e3,
                    device_busy_ms="not measured", idle_share="not measured")
    bounce_ms = sum(us for us, k in kern if "bounce_kernel" in k) / 1e3
    return dict(**meta, wall_ms=wall * 1e3, device_busy_ms=busy_ms,
                idle_share=1.0 - busy_ms / (wall * 1e3), bounce_kernel_ms=bounce_ms,
                n_kernel_names=len(kern),
                top_kernels=[[k[:80], us / 1e3] for us, k in kern[:10]])
