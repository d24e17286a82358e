"""The bounce kernel's share of its roofline over the traced frames: the
least time of the frames' kernel work (benchmark/roofline.py, work
counted by the reference on its sample of the cell's rays) over the
kernel's device time in the trace. None when the trace holds no launch
of the kernel."""

from benchmark import roofline

KERNEL = "bounce_kernel"


def read(ctx):
    if ctx.trace is None or not ctx.work.get("rays"):
        return None
    kernel_s = ctx.trace.device_s(having=KERNEL)
    if kernel_s <= 0.0:
        return None
    c, wl = ctx.cfg, ctx.wl
    rays = ctx.stats["frames"] * c["width"] * c["height"] * wl["spp"]
    per_ray = rays / ctx.work["rays"]
    least = roofline.least_seconds(
        rays=rays, live_ray_bounces=ctx.work["live_ray_bounces"] * per_ray,
        live_misses=ctx.work["live_misses"] * per_ray, spheres=ctx.work["spheres"],
        has_sky=len(c["sky"]) == 2, frames=ctx.stats["frames"])
    return 100.0 * least["least_s"] / kernel_s
