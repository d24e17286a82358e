"""The bounce kernel's share of its roofline over the traced frames of a
rect scene with no sphere: the least time of the frames' kernel work over
the kernel's device time in the trace. Under a black background this is
the static, flat-sky instantiation. None when the trace holds no launch of
the kernel.

The operations are those a rect test needs, not the 6 dense 17-wide
coefficient rows that benchmark/roofline.py charges a rect (the kernel's
dense dot products multiply 81 of their 102 coefficients by zero): per
live ray-bounce and real rect, the nonzero terms of its six rows (kn, ua
and vb: 3 origin terms and a constant; dn, da and db: 3 direction terms),
3 multiply-adds each, one division for t and two multiply-adds for u and
v. Live ray-bounces come from the reference's trace of a sample of the
cell's rays. The bytes are benchmark/roofline.py's least: each ray's state
read and its radiance written once, and each rect's nonzero row words and
attributes once a frame."""

from benchmark import roofline

KERNEL = "bounce_kernel"
# FLOP of one (live ray-bounce, rect) test: 6 rows of 3 multiply-adds, the
# division t = kn / dn, then u = ua + t da and v = vb + t db
RECT_FLOP = 6 * 3 * 2 + 1 + 2 * 2
# nonzero words of a rect's six rows: kn, ua, vb 4 each; dn, da, db 3 each
RECT_ROW_WORDS = 3 * 4 + 3 * 3


def least_seconds(*, rays: int, live_ray_bounces: float, rects: int, frames: int) -> float:
    ops = live_ray_bounces * rects * RECT_FLOP
    nbytes = (rays * (roofline.STATE_WORDS + roofline.RADIANCE_WORDS) * 4
              + frames * rects * (RECT_ROW_WORDS + roofline.ATTR_WORDS) * 4)
    return max(ops / roofline.FP32_FLOPS, nbytes / roofline.HBM_BYTES_S)


def read(ctx):
    if ctx.trace is None or not ctx.work.get("rays") or not ctx.work.get("rects"):
        return None
    kernel_s = ctx.trace.device_s(having=KERNEL)
    if kernel_s <= 0.0:
        return None
    c, wl = ctx.cfg, ctx.wl
    rays = ctx.stats["frames"] * c["width"] * c["height"] * wl["spp"]
    least = least_seconds(
        rays=rays, live_ray_bounces=ctx.work["live_ray_bounces"] * rays / ctx.work["rays"],
        rects=ctx.work["rects"], frames=ctx.stats["frames"])
    return 100.0 * least / kernel_s
