"""Command-line renderer for the PyTorch/CUDA port.

    python -m rtweekend_tpu_torch.cli final_scene --spp 16 -o out.png

Renders on the card; `--cpu` renders on the CPU with the plain version
of the bounce kernel.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from rtweekend_tpu_torch.config import SCENE_DEFAULTS, RenderConfig
from rtweekend_tpu_torch.ops.cuda.megakernel import KERNELS

# Flags of rtweekend_tpu.cli that this port does not have yet. They are
# accepted by the parser only to be refused with a clear message.
_NOT_PORTED = {
    "--checkpoint": "resumable rendering",
    "--profile-dir": "profiler traces",
    "--metrics": "JSON-lines metrics",
    "--adaptive-caps": "the measured compaction schedule",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="rtweekend-tpu-torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("scene", nargs="?", default="cornell_box", choices=sorted(SCENE_DEFAULTS))
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--spp", type=int, default=None, help="samples per pixel")
    p.add_argument("--max-depth", type=int, default=50)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--output", "-o", default="out.png")
    p.add_argument("--ppm", action="store_true", help="also write a P3 .ppm next to the output")
    p.add_argument("--rays-per-chunk", type=int, default=1 << 20)
    p.add_argument("--cpu", action="store_true", help="render on the CPU")
    p.add_argument(
        "--kernel", choices=KERNELS, default="auto",
        help="bounce implementation: auto = the CUDA kernel on the card and "
             "the plain version on the CPU; torch = the plain version",
    )
    p.add_argument("--dtype", default="float32", choices=["float32", "float64"],
                   help="float32 only; float64 is not ported yet and is refused")
    for flag, what in _NOT_PORTED.items():
        kw = dict(action="store_true") if flag == "--adaptive-caps" else dict(default=None)
        p.add_argument(flag, help=f"not ported yet ({what}); refused", **kw)
    return p


def main(argv=None) -> int:
    p = build_parser()
    args = p.parse_args(argv)
    for flag in _NOT_PORTED:
        if getattr(args, flag.lstrip("-").replace("-", "_")):
            p.error(f"{flag} is not ported to rtweekend_tpu_torch yet "
                    f"({_NOT_PORTED[flag]})")
    if args.dtype != "float32":
        p.error("--dtype float64 is not ported to rtweekend_tpu_torch yet")

    from rtweekend_tpu_torch.render import render_image
    from rtweekend_tpu_torch.utils import image as image_mod

    defaults = SCENE_DEFAULTS[args.scene]
    cfg = RenderConfig(
        scene=args.scene,
        width=args.width or defaults["width"],
        height=args.height or defaults["height"],
        samples_per_pixel=args.spp or defaults["samples_per_pixel"],
        max_depth=args.max_depth,
        seed=args.seed,
        rays_per_chunk=args.rays_per_chunk,
        output=args.output,
    )
    t0 = time.time()
    img, accum = render_image(
        cfg, device="cpu" if args.cpu else None, kernel=args.kernel, progress=True
    )
    dt = time.time() - t0

    # Loud failure: non-finite radiance must never tone-map into a
    # silently black PNG.
    if not np.isfinite(accum.cpu().numpy()).all():
        raise RuntimeError(
            "render produced non-finite radiance (NaN/Inf): a kernel bug or an "
            "unrecovered compaction overflow; re-run with --kernel torch to bisect"
        )
    image_mod.write_png(cfg.output, img)
    if args.ppm:
        image_mod.write_ppm(cfg.output.rsplit(".", 1)[0] + ".ppm", img)
    n_rays = cfg.width * cfg.height * cfg.samples_per_pixel
    print(
        f"wrote {cfg.output}: {cfg.width}x{cfg.height} @ {cfg.samples_per_pixel}spp "
        f"in {dt:.1f}s ({n_rays / dt / 1e6:.3f} Mray/s primary incl. kernel build)"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
