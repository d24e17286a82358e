"""The traced window's share of time in which no operation ran on the
device: 1 - (union of device intervals) / window."""


def read(ctx):
    return None if ctx.trace is None else ctx.trace.idle_pct()
