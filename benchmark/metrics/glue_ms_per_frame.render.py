"""Device time outside the bounce kernel per traced frame: ray
generation, compaction, the radiance scatter, pixel sums, tone map and
copies."""

KERNEL = "bounce_kernel"


def read(ctx):
    if ctx.trace is None or not ctx.stats.get("frames"):
        return None
    return 1e3 * ctx.trace.device_s(lacking=KERNEL) / ctx.stats["frames"]
