"""Seconds of the compaction schedule's CPU probe, by the host clock
around the harness's first `adaptive_capacities` call at set-up
(render_image then finds the schedule cached)."""


def read(ctx):
    return ctx.stats.get("probe_s")
