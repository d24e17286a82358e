"""Device time of work enqueued from Python, on the card.

CUDA events recorded around Python calls bracket the host's enqueueing as
well as the device's work: when a launch takes less time than the call
that enqueues it, the events measure how fast Python enqueues. device_ms
puts the calls behind torch.cuda._sleep, a device-side spin long enough to
outlast the enqueueing, so that the start event fires only once every
call is queued and the events bracket device time alone.
"""

from __future__ import annotations

import time

# spin cycles per second of host enqueueing to cover: the H100's SM clock
# (1.98 GHz at most) with room to spare
_CYCLES_PER_S = 4e9


def device_ms(fn, reps: int, *, tries: int = 4):
    """(device ms per call, host ms per call) of fn() over `reps` calls,
    after one warm-up call. The host time is that of the enqueueing loop
    alone. Raises if no spin covered the enqueueing (fn synchronises, or
    the host stalled) after `tries` spins, each 4x the last."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    cycles = int(host_s * reps * _CYCLES_PER_S) + 1_000_000
    for _ in range(tries):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        covered = not start.query()   # still spinning once every call was queued
        torch.cuda.synchronize()
        if covered:
            return start.elapsed_time(end) / reps, host_s * 1e3
        cycles *= 4
    raise RuntimeError(f"the device spin never outlasted {reps} enqueued calls")
