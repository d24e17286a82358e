"""Frames back to back, as the command line renders them: `render_image`
of a RenderConfig at the cell's size and sample count, the CLI's check
that the radiance is finite, then `write_png` (cli.py). A closed loop:
the next frame starts when the last PNG is written. Frame f renders
with its own seed, derived from the run's seed, which draws both the
scene's layout and the samples.

The check decodes a sample of the window's PNG files with the
benchmark's own reader and holds a sample of their pixels against the
reference's trace of every sample of those pixels, tone-mapped the same
way: the share of pixels with a channel more than 2 levels (of 255) off,
and the mean level difference.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import seeds
from benchmark.reference import camera, png, scenes, tracer


def tone_map(sums, spp: int) -> np.ndarray:
    """uint8 levels of radiance sums: floor(256 clamp(sqrt(sum / spp), 0, 0.999))."""
    return np.floor(256.0 * np.clip(np.sqrt(np.asarray(sums, np.float64) / spp),
                                    0.0, 0.999)).astype(np.int64)


class Job:
    def __init__(self, cfg: dict, wl: dict, seed: int, device, outdir, trace: bool):
        self.cfg, self.wl, self.seed, self.device = cfg, wl, seed, device
        self.outdir, self.trace = outdir, trace
        self.frames = []      # (frame seed, wall s, png s, path)
        self.nonfinite = 0
        self.stats = {}

    # ---- the program's side ----
    def _render(self, frame_seed: int, spp: int, path):
        from rtweekend_tpu_torch import config, render
        from rtweekend_tpu_torch.utils import image

        rc = config.RenderConfig(self.cfg["scene"], self.cfg["width"], self.cfg["height"], spp,
                                 self.cfg["max_depth"], seed=frame_seed)
        t0 = time.perf_counter()
        with torch.profiler.record_function("render_image"):
            img, accum = render.render_image(rc, device=self.device)
        with torch.profiler.record_function("finite_check"):
            finite = bool(np.isfinite(accum.cpu().numpy()).all())
        t1 = time.perf_counter()
        with torch.profiler.record_function("write_png"):
            image.write_png(path, img)
        t2 = time.perf_counter()
        return finite, t2 - t0, t2 - t1

    def setup(self):
        from rtweekend_tpu_torch import config, render

        bg = config.SCENE_DEFAULTS[self.cfg["scene"]]["background"]
        t0 = time.perf_counter()
        render.adaptive_capacities(self.cfg["scene"], bg, self.cfg["max_depth"])
        self.stats["probe_s"] = time.perf_counter() - t0
        # one frame of the window's shapes: spp = the window's batch of samples
        self._render(seeds.derive(self.seed, "warm"), self.wl["warm_spp"],
                     self.outdir / "warm.png")

    def window(self, seconds: float, max_units: int | None = None):
        t0 = time.perf_counter()
        while True:
            f = len(self.frames)
            fs = seeds.derive(self.seed, "frame", f)
            path = self.outdir / f"frame_{f:05d}.png"
            finite, wall, png_s = self._render(fs, self.wl["spp"], path)
            self.nonfinite += not finite
            self.frames.append((fs, wall, png_s, path))
            elapsed = time.perf_counter() - t0
            if elapsed >= seconds or (max_units and len(self.frames) >= max_units):
                break
        self.wall_s = elapsed
        self.stats.update(frames=len(self.frames), png_s=[f[2] for f in self.frames])

    def end_to_end(self) -> dict:
        n = len(self.frames)
        rays = n * self.cfg["width"] * self.cfg["height"] * self.wl["spp"]
        walls = [f[1] for f in self.frames]
        return {"render_rays_per_s": rays / self.wall_s,
                "frame_s_p90": float(np.percentile(walls, 90))}

    def attempted_failed(self):
        return len(self.frames), self.nonfinite

    def release(self):
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ---- the check ----
    def _reference_levels(self, frame_seed, pids, march, counts):
        cfg, spp = self.cfg, self.wl["spp"]
        sc = tracer.scene_tensors(scenes.build(cfg["scene"], frame_seed), self.device)
        if counts is not None:
            counts["spheres_x_frames"] = counts.get("spheres_x_frames", 0) + sc["n_spheres"]
        cam = camera.camera(cfg["look_from"], cfg["look_at"], cfg["vfov"],
                            cfg["width"] / cfg["height"], cfg["aperture"], cfg["focus_dist"])
        sums = np.zeros((len(pids), 3))
        per = max(1, self.wl["ref_block_rays"] // spp)
        for i in range(0, len(pids), per):
            p = torch.as_tensor(pids[i:i + per], dtype=torch.int32, device=self.device)
            pid = p.repeat_interleave(spp)
            sid = torch.arange(spp, dtype=torch.int32, device=self.device).repeat(p.numel())
            o, d, t = camera.rays(cam, cfg["width"], cfg["height"], pid, sid, frame_seed)
            rad = tracer.trace(sc, o, d, t, pid, sid, frame_seed, cfg["sky"], cfg["max_depth"],
                               march=march, counts=counts)
            sums[i:i + per] = rad.double().reshape(-1, spp, 3).sum(1).cpu().numpy()
        return tone_map(sums, spp)

    def check(self, control: bool = False):
        """(numbers compared, work counts): the program's PNGs, or with
        `control` the reference traced in TF32 in the program's place."""
        cfg, wl = self.cfg, self.wl
        w, h = cfg["width"], cfg["height"]
        pick = seeds.rng(self.seed, "check")
        n = len(self.frames)
        chosen = sorted(pick.choice(n, size=min(n, wl["check_frames"]), replace=False))
        counts = {"rays": 0}
        got, want = [], []
        for f in chosen:
            fs, _, _, path = self.frames[f]
            pids = pick.choice(w * h, size=wl["check_pixels"], replace=False)
            ref = self._reference_levels(fs, pids, "fp32", counts)
            counts["rays"] += len(pids) * wl["spp"]
            if control:
                out = self._reference_levels(fs, pids, "tf32", None)
            else:
                img = png.read(path)
                if img.shape != (h, w, 3):
                    raise ValueError(f"{path}: image {img.shape}, expected {(h, w, 3)}")
                out = img[h - 1 - pids // w, pids % w].astype(np.int64)
            got.append(out)
            want.append(ref)
        counts["spheres"] = counts.pop("spheres_x_frames", 0) / max(1, len(chosen))
        diff = np.abs(np.concatenate(got) - np.concatenate(want))
        numbers = {"off2_pct": 100.0 * float((diff > 2).any(axis=1).mean()),
                   "mean_abs_diff": float(diff.mean())}
        return numbers, counts
