"""Uncompacted re-traces a traced frame of batches whose compaction
overflowed: the change of the program's `retrace_launches` counter over
the window (`megakernel.launch_counts()`, recorded by the job) over the
frames. None where the program has no such counter."""


def read(ctx):
    n = (ctx.stats.get("launches") or {}).get("retrace_launches")
    return None if n is None or not ctx.stats.get("frames") else n / ctx.stats["frames"]
