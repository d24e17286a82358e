"""Frames of a rect scene back to back (the Cornell box): render_frames'
closed loop of `render_image`, the finite check and `write_png`, held
against the rect reference (reference/rect_scenes.py, rect_tracer.py)
instead of the sphere one. The scene is fixed; each frame's seed, derived
from the run's, draws its samples.

The window also records in `stats["launches"]` the change of each of the
program's launch counters over the window (`megakernel.launch_counts()`):
the counters the program has, and no others.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.jobs import render_frames
from benchmark.reference import camera, rect_scenes, rect_tracer


class Job(render_frames.Job):
    def window(self, seconds: float, max_units: int | None = None):
        from rtweekend_tpu_torch.ops.cuda.megakernel import launch_counts

        before = launch_counts()
        super().window(seconds, max_units)
        after = launch_counts()
        self.stats["launches"] = {k: v - before.get(k, 0) for k, v in after.items()}

    def _reference_levels(self, frame_seed, pids, march, counts):
        cfg, spp = self.cfg, self.wl["spp"]
        sc = rect_tracer.scene_tensors(rect_scenes.build(cfg["scene"]), self.device)
        if counts is not None:
            counts["rects"] = sc["n_rects"]
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
            rad = rect_tracer.trace(sc, o, d, t, pid, sid, frame_seed, cfg["sky"],
                                    cfg["max_depth"], march=march, counts=counts)
            sums[i:i + per] = rad.double().reshape(-1, spp, 3).sum(1).cpu().numpy()
        return render_frames.tone_map(sums, spp)
