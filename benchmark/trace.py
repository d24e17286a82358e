"""Reduction of a torch.profiler trace to the numbers the per-layer
metrics read: device intervals inside the traced window, their union
(busy time), device time by operation name, and idle gaps labelled by
the host operation in flight.

The interval arithmetic is a copy of the program's trace report
(`_length_of_union`); the benchmark keeps its own so that a change to
the program cannot change the yardstick.
"""

from __future__ import annotations

import collections
import dataclasses

WINDOW = "bench_window"


def length_of_union(intervals) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


@dataclasses.dataclass
class Trace:
    """Times in seconds from the start of the traced window."""
    window_s: float
    device: list            # [(start, end, name)] of device operations
    host: list              # [(start, end, name)] of host ops on the window's thread

    def busy_s(self) -> float:
        return length_of_union((a, b) for a, b, _ in self.device)

    def idle_pct(self):
        """The window's share of time with no device operation, in %; None
        for a trace with no device operation."""
        if self.window_s <= 0.0 or not self.device:
            return None
        return 100.0 * (1.0 - self.busy_s() / self.window_s)

    def device_s(self, having: str = "", lacking: str = "") -> float:
        """Device seconds of the operations whose name holds `having` and
        not `lacking` (empty: no condition)."""
        return sum(b - a for a, b, name in self.device
                   if having in name and not (lacking and lacking in name))

    def device_s_by_name(self) -> dict:
        out = collections.Counter()
        for a, b, name in self.device:
            out[name] += b - a
        return dict(out)

    def idle_gaps(self) -> list:
        """[(start, end)] of the window's instants with no device operation."""
        gaps, end = [], 0.0
        for a, b in sorted((a, b) for a, b, _ in self.device):
            if a > end:
                gaps.append((end, a))
            end = max(end, b)
        if end < self.window_s:
            gaps.append((end, self.window_s))
        return gaps

    def idle_by_host_op(self) -> dict:
        """Idle seconds summed by the innermost host op in flight at each
        gap's midpoint ("none" where the host was between ops)."""
        gaps = sorted(self.idle_gaps(), key=lambda g: g[0] + g[1])
        ops = sorted(self.host)
        out = collections.Counter()
        stack, i = [], 0
        for g0, g1 in gaps:
            mid = 0.5 * (g0 + g1)
            while i < len(ops) and ops[i][0] <= mid:
                while stack and stack[-1][1] < ops[i][0]:
                    stack.pop()
                stack.append(ops[i])
                i += 1
            while stack and stack[-1][1] < mid:
                stack.pop()
            out[stack[-1][2] if stack else "none"] += g1 - g0
        return dict(out)

    def breakdown(self, top: int = 10) -> dict:
        def ranked(d):
            return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": ranked(self.device_s_by_name()),
                "idle_gaps": ranked(self.idle_by_host_op())}


def from_events(events) -> Trace:
    """The Trace of profiler events (name, on_device, start_ns, end_ns,
    thread), windowed by the one host span named WINDOW: device
    operations, and the host ops on the window's thread."""
    events = list(events)
    win = [e for e in events if e[0] == WINDOW and not e[1]]
    if len(win) != 1:
        raise RuntimeError(f"expected one {WINDOW!r} span in the trace, found {len(win)}")
    _, _, w0, w1, thread = win[0]
    # a host span named by record_function is mirrored on the device's
    # timeline as an annotation, which is no device operation
    host_names = {e[0] for e in events if not e[1]}
    device, host = [], []
    for e in events:
        name, on_device, a, b, tid = e
        if b <= w0 or a >= w1 or e is win[0]:
            continue
        span = ((max(a, w0) - w0) * 1e-9, (min(b, w1) - w0) * 1e-9, name)
        if on_device:
            if name not in host_names:
                device.append(span)
        elif tid == thread:
            host.append(span)
    return Trace(window_s=(w1 - w0) * 1e-9, device=device, host=host)


def from_profiler(prof) -> Trace:
    """The Trace of a finished torch.profiler.profile that recorded a
    `record_function(WINDOW)` span around the measured work."""
    from torch.autograd import DeviceType

    return from_events(
        (e.name(), e.device_type() == DeviceType.CUDA, e.start_ns(),
         e.start_ns() + e.duration_ns(), e.start_thread_id())
        for e in prof.profiler.kineto_results.events())
