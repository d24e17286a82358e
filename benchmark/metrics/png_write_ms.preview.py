"""Milliseconds of `write_png` a frame, by the host clock around the
harness's call (encode and write of the tone-mapped frame)."""


def read(ctx):
    png = ctx.stats.get("png_s") or []
    return 1e3 * sum(png) / len(png) if png else None
