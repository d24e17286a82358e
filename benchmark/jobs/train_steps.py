"""Inverse rendering steps: `parallel.shard.sharded_train_step(mesh=None)`
on the kernel path, the parameters carried from step to step.

Set-up makes the inputs: the scene's layout from the run's seed, a target
image (the true scene's mean image, traced by the benchmark's reference)
and the starting parameters (the true scene with its albedos scaled and
its small spheres moved and resized, drawn from the seed). It builds the
program's scene once, drives it through the first three steps, and hands
that same state to the window, which goes on stepping. Step k draws its
samples with its own seed.

The check follows the three set-up steps and a sample of the window's own
steps (its last, and others drawn from the seed) with the reference's own
step, each from the state the program's previous step left (p0, the
benchmark's own, for the first). It compares each checked step's loss;
for the albedo (the texture colours) each checked step's gradient norm,
read from the program's states (SGD: (p_k-1 - p_k) / lr), and the change
after the three set-up steps against the sum of the reference's three
updates; for the geometry (centres and radii) the median over spheres of
each sphere's gap of gradient norms. A gap of norms is taken against the
reference's norm.

Why not every leaf whole, nor two independent runs: along a path fixed by
the tracer's decisions, a ray that grazes a sphere has a hit distance whose
derivative in the centre and radius grows as 1 / sqrt(discriminant), and
whether such a ray hits is decided by the discriminant's rounding. So one
grazing ray that the kernel and the reference decide apart can carry most
of the gradient of the centres, radii, fuzz or ior (PERF.md: with only the
discriminant's rounding changed, the reference's own norms of those
leaves move by 34-98%, the albedo's by 8e-5), and two runs from states a
rounding apart part ways within a step. Such a ray moves one or two
spheres, so the median sphere is compared; its reading is coarse (sound
runs 0.08-0.12, PERF.md), since most spheres' updates span only a few
float32 steps of their centre, and the check reads the gradient back from
the states. The albedo enters the radiance as a factor, with no hit
distance in between. Every leaf's gaps are kept in the
job's stats for the readings.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import seeds
from benchmark.reference import camera, scenes, tracer, train

CHECKED_STEPS = 3       # the set-up steps the reference follows
WINDOW_CHECKED = 2      # window steps it checks: the last, and others drawn from the seed
COMPARED_LEAF = "color"


class Job:
    def __init__(self, cfg: dict, wl: dict, seed: int, device, outdir, trace: bool):
        self.cfg, self.wl, self.seed, self.device, self.trace = cfg, wl, seed, device, trace
        self.stats = {"timings": []}
        self.losses, self.window_losses = [], []
        self.window_states = []     # the state after each window step

    def _ref_camera(self):
        c = self.cfg
        return camera.camera(c["look_from"], c["look_at"], c["vfov"], c["width"] / c["height"],
                             c["aperture"], c["focus_dist"])

    def _inputs(self):
        """The benchmark's inputs: reference scene tensors, starting
        parameters p0, the target [n_pix, 3] in pixel-id order."""
        c, wl = self.cfg, self.wl
        self.layout_seed = seeds.derive(self.seed, "layout")
        sc = tracer.scene_tensors(scenes.build(c["scene"], self.layout_seed), self.device)
        g = seeds.rng(self.seed, "perturb")
        small = (sc["radius"] < 10.0) & sc["active"]
        n_tex = sc["color"].shape[0]

        def t(x):
            return torch.as_tensor(x, dtype=torch.float32, device=self.device)

        p0 = {k: sc[k].clone() for k in tracer.PARAMS}
        p0["color"] = p0["color"] * t(g.uniform(0.7, 0.9, (n_tex, 3)))
        move = t(g.normal(0.0, wl["move_sd"], sc["c0"].shape))
        p0["c0"] = p0["c0"] + torch.where(small[:, None], move, 0.0)
        grow = t(1.0 + g.normal(0.0, wl["resize_sd"], sc["radius"].shape))
        p0["radius"] = torch.where(small, p0["radius"] * grow, p0["radius"])
        target = train.mean_image(sc, self._ref_camera(), c["width"], c["height"],
                                  wl["target_spp"], c["max_depth"], c["sky"],
                                  seeds.derive(self.seed, "target"),
                                  block_rays=wl["ref_block_rays"])
        return sc, p0, target

    def _step(self, k: int, timings=None):
        from rtweekend_tpu_torch.config import SCENE_DEFAULTS
        from rtweekend_tpu_torch.parallel import shard

        c, wl = self.cfg, self.wl
        with torch.profiler.record_function("train_step"):
            new, loss = shard.sharded_train_step(
                self.scene, self.camera, self.target_img, c["width"], c["height"], wl["spp"],
                c["max_depth"], SCENE_DEFAULTS[c["scene"]]["background"],
                seeds.derive(self.seed, "step", k), mesh=None, lr=wl["lr"], timings=timings)
            self.scene = shard.merge_params(self.scene, new)
            return float(loss), new

    def setup(self):
        from rtweekend_tpu_torch.models.builders import build_scene
        from rtweekend_tpu_torch.parallel import shard
        from rtweekend_tpu_torch.render import camera_for_scene

        c = self.cfg
        t0 = time.perf_counter()
        self.ref_scene, self.p0, self.target = self._inputs()
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            # the reference's target trace sets no peak of the program's
            torch.cuda.reset_peak_memory_stats(self.device)
        self.stats["reference_setup_s"] = time.perf_counter() - t0
        img = torch.flip(self.target.reshape(c["height"], c["width"], 3), [0])
        self.target_img = img.contiguous()
        scene = build_scene(c["scene"], seed=self.layout_seed, device=self.device)
        self.scene = shard.merge_params(scene, {k: v.clone() for k, v in self.p0.items()})
        self.camera = camera_for_scene(c["scene"], c["width"] / c["height"], self.device)
        self.states = [self.p0]
        for k in range(CHECKED_STEPS):
            loss, new = self._step(k)
            self.losses.append(loss)
            self.states.append({n: v.clone() for n, v in new.items()})

    def window(self, seconds: float, max_units: int | None = None):
        t0 = time.perf_counter()
        k = CHECKED_STEPS
        while True:
            tm = {} if self.trace else None
            loss, new = self._step(k, tm)
            self.window_losses.append(loss)
            self.window_states.append({n: v.clone() for n, v in new.items()})
            if tm is not None:
                self.stats["timings"].append(tm)
            k += 1
            elapsed = time.perf_counter() - t0
            if elapsed >= seconds or (max_units and len(self.window_losses) >= max_units):
                break
        self.wall_s = elapsed

    def end_to_end(self) -> dict:
        return {"train_step_s": self.wall_s / len(self.window_losses)}

    def attempted_failed(self):
        bad = sum(not np.isfinite(x) for x in self.window_losses)
        return len(self.window_losses), bad

    def release(self):
        del self.scene, self.camera, self.target_img
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ---- the check ----
    def _checked(self):
        """[(step, state before, state after, the program's loss)] of the
        set-up steps and the sampled window steps."""
        out = [(k, self.states[k], self.states[k + 1], self.losses[k])
               for k in range(CHECKED_STEPS)]
        n = len(self.window_states)
        pick = seeds.rng(self.seed, "check")
        drawn = pick.choice(n - 1, size=min(n - 1, WINDOW_CHECKED - 1), replace=False)
        before = [self.states[-1]] + self.window_states[:-1]
        for j in sorted({n - 1, *drawn.tolist()}):
            out.append((CHECKED_STEPS + j, before[j], self.window_states[j],
                        self.window_losses[j]))
        return out

    def _reference_step(self, k: int, state: dict, march: str):
        c, wl = self.cfg, self.wl
        return train.step(self.ref_scene, state, self._ref_camera(), self.target,
                          c["width"], c["height"], wl["spp"], c["max_depth"], c["sky"],
                          seeds.derive(self.seed, "step", k), wl["lr"], march=march,
                          block_rays=wl["ref_block_rays"])

    def _geometry_gap(self, grads: dict, before: dict, after: dict) -> float:
        """The median over spheres of the gap of each sphere's centre-and-
        radius gradient norm, over the spheres whose reference norm is at
        least a thousandth of the median moving sphere's."""
        lr = self.wl["lr"]
        act = self.ref_scene["active"]

        def per_sphere(gc, gr):
            return torch.sqrt((gc.double() ** 2).sum(1) + gr.double() ** 2)[act]

        ref = per_sphere(grads["c0"], grads["radius"])
        got = per_sphere((before["c0"] - after["c0"]) / lr,
                         (before["radius"] - after["radius"]) / lr)
        keep = ref >= 1e-3 * ref[ref > 0].median()
        return float(((got[keep] - ref[keep]).abs() / ref[keep]).median())

    def check(self, control: bool = False):
        """(numbers compared, work counts): the program's checked steps, or
        with `control` the reference's own steps in TF32 in the program's
        place (its own three set-up steps from p0, then its step from the
        program's state before each sampled window step)."""
        lr = self.wl["lr"]
        steps = self._checked()
        if control:
            own, ctrl = [self.p0], []
            for k, before, _, _ in steps:
                start = own[k] if k < CHECKED_STEPS else before
                new, loss, _ = self._reference_step(k, start, "tf32")
                if k < CHECKED_STEPS:
                    own.append(new)
                ctrl.append((k, start, new, loss))
            steps = ctrl

        def norm(x):
            return float(torch.linalg.vector_norm(x.double()))

        loss_gap, grad_gap, geom_gap = 0.0, {}, 0.0
        total = None
        for k, before, after, loss in steps:
            _, ref_loss, grads = self._reference_step(k, before, "fp32")
            loss_gap = max(loss_gap, abs(loss - ref_loss) / ref_loss)
            for n, g in grads.items():
                g_ref = norm(g)
                g_got = norm((before[n] - after[n]) / lr)
                grad_gap[n] = max(grad_gap.get(n, 0.0), abs(g_got - g_ref) / max(g_ref, 1e-30))
            geom_gap = max(geom_gap, self._geometry_gap(grads, before, after))
            if k < CHECKED_STEPS:
                upd = {n: lr * g for n, g in grads.items()}
                total = upd if total is None else {n: total[n] + upd[n] for n in total}
        first, last = steps[0][1], steps[CHECKED_STEPS - 1][2]
        change_gap = {}
        for n in total:
            c_ref = norm(total[n])
            change_gap[n] = abs(norm(last[n] - first[n]) - c_ref) / max(c_ref, 1e-30)
        numbers = {
            "loss_gap": loss_gap,
            "grad_gap": grad_gap[COMPARED_LEAF],
            "change_gap": change_gap[COMPARED_LEAF],
            "geom_grad_gap": geom_gap,
        }
        self.stats["leaf_gaps"] = {"grad": grad_gap, "change": change_gap,
                                   "checked_steps": [k for k, *_ in steps]}
        return numbers, {}
