"""Command-line renderer for the PyTorch/CUDA port.

    python -m rtweekend_tpu_torch.cli final_scene --spp 16 -o out.png

Renders on the card; `--cpu` renders on the CPU. The flags are those of
rtweekend_tpu.cli: scene, size, samples, depth, seed, dtype, the tracer
(`--kernel`), the measured compaction schedule, resumable rendering,
profiler traces and JSON-lines metrics.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from rtweekend_tpu_torch.config import SCENE_DEFAULTS, RenderConfig
from rtweekend_tpu_torch.render import RENDER_KERNELS


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="rtweekend-tpu-torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("scene", nargs="?", default="cornell_box", choices=sorted(SCENE_DEFAULTS))
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--spp", type=int, default=None, help="samples per pixel")
    p.add_argument("--max-depth", type=int, default=50)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--dtype", default="float32", choices=["float32", "float64"],
                   help="float64 renders through the eager integrator")
    p.add_argument("--output", "-o", default="out.png")
    p.add_argument("--ppm", action="store_true", help="also write a P3 .ppm next to the output")
    p.add_argument("--rays-per-chunk", type=int, default=1 << 20)
    p.add_argument("--cpu", action="store_true", help="render on the CPU")
    p.add_argument(
        "--kernel", choices=RENDER_KERNELS, default="auto",
        help="tracer: auto = the CUDA bounce kernel on the card, its plain version "
             "on the CPU, the eager integrator for float64; cuda; torch = the plain "
             "version; eager = the eager integrator (no compaction)",
    )
    p.add_argument(
        "--adaptive-caps", action="store_true",
        help="derive the compaction schedule from a CPU alive-fraction probe and "
             "print it (render_image uses it on the kernel path either way)",
    )
    p.add_argument("--checkpoint", default=None, metavar="PATH",
                   help="checkpoint file for resumable rendering")
    p.add_argument("--profile-dir", default=None, metavar="DIR",
                   help="write a torch.profiler Chrome trace into DIR")
    p.add_argument("--metrics", default=None, metavar="PATH",
                   help="append structured JSON-lines render metrics to PATH")
    return p


def main(argv=None) -> int:
    p = build_parser()
    args = p.parse_args(argv)
    if args.dtype == "float64" and args.kernel in ("cuda", "torch"):
        p.error(f"--kernel {args.kernel} is float32 only; --dtype float64 renders "
                "through the eager integrator (--kernel eager or auto)")

    from rtweekend_tpu_torch.render import adaptive_capacities, render_image
    from rtweekend_tpu_torch.utils import image as image_mod
    from rtweekend_tpu_torch.utils import profiling

    defaults = SCENE_DEFAULTS[args.scene]
    cfg = RenderConfig(
        scene=args.scene,
        width=args.width or defaults["width"],
        height=args.height or defaults["height"],
        samples_per_pixel=args.spp or defaults["samples_per_pixel"],
        max_depth=args.max_depth,
        seed=args.seed,
        dtype=args.dtype,
        rays_per_chunk=args.rays_per_chunk,
        output=args.output,
    )
    device = "cpu" if args.cpu else None

    metrics = None
    if args.metrics:
        from rtweekend_tpu_torch.utils.metrics import MetricsLogger

        metrics = MetricsLogger(args.metrics)

    capacities = None
    if args.adaptive_caps:
        capacities = adaptive_capacities(cfg.scene, defaults["background"], cfg.max_depth)
        print(f"adaptive compaction schedule: {capacities}")

    t0 = time.time()
    with profiling.trace(args.profile_dir):
        if args.checkpoint:
            from rtweekend_tpu_torch import checkpoint as ckpt
            from rtweekend_tpu_torch.models.builders import build_scene
            from rtweekend_tpu_torch.render import camera_for_scene

            dtype = cfg.torch_dtype
            scene = build_scene(cfg.scene, seed=cfg.seed, device=device, dtype=dtype)
            camera = camera_for_scene(cfg.scene, cfg.width / cfg.height, device, dtype)
            accum = ckpt.render_resumable(
                scene, camera, cfg.scene, cfg.width, cfg.height, cfg.samples_per_pixel,
                cfg.max_depth, defaults["background"], cfg.seed, args.checkpoint,
                rays_per_chunk=cfg.rays_per_chunk, kernel=args.kernel, progress=True,
            )
            img = image_mod.tonemap(accum, cfg.samples_per_pixel).cpu().numpy()
        else:
            img, accum = render_image(cfg, device=device, kernel=args.kernel, progress=True,
                                      metrics=metrics, capacities=capacities)
    dt = time.time() - t0
    if metrics is not None:
        metrics.close()

    # Loud failure: non-finite radiance must never tone-map into a
    # silently black PNG.
    if not np.isfinite(accum.cpu().numpy()).all():
        raise RuntimeError(
            "render produced non-finite radiance (NaN/Inf): a kernel bug or an "
            "unrecovered compaction overflow; re-run with --kernel torch or eager to bisect"
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
