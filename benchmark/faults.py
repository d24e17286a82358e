"""Faults planted under the timed path, to show that the check catches
them (benchmark/readings.py on the card, benchmark/tests on the CPU):

- "stale": a step that returns its state unchanged (a frame that is the
  previous frame again; a train step that returns the parameters it was
  given);
- "half": half of the samples left out, the mean taken over the rest;
- "alter": an answer altered where it is produced (the radiance of every
  16th ray zeroed as the compacted tracer, or the replay, returns it);
- "stale_late" (training): the state left unchanged only by the steps
  after the set-up's, as a step that goes stale once the window runs;
- "geometry" (training): the centres' and radii's update dropped, as a
  backward that loses the hit distance's derivative.

The cells run on one card, so the fault of an exchange between cards
does not arise.
"""

from __future__ import annotations

import contextlib
import dataclasses

FAULTS = {"render_frames": ("stale", "half", "alter"),
          "train_steps": ("stale", "half", "alter", "stale_late", "geometry")}


def _zero_every_16th(rad):
    rad = rad.clone()
    rad[::16] = 0.0
    return rad


@contextlib.contextmanager
def planted(kind: str):
    from rtweekend_tpu_torch import render
    from rtweekend_tpu_torch.parallel import shard

    saved = {(render, "render_image"): render.render_image,
             (render, "trace_paths_compact"): render.trace_paths_compact,
             (shard, "sharded_train_step"): shard.sharded_train_step,
             (shard, "trace_paths_replay_fast"): shard.trace_paths_replay_fast}
    real_render, real_step = render.render_image, shard.sharded_train_step
    if kind == "stale":
        last = []

        def stale_render(config, **kw):
            out = last[0] if last else real_render(config, **kw)
            last[:] = [out]
            return out

        def stale_step(scene, *args, **kw):
            _, loss = real_step(scene, *args, **kw)
            return {k: v.detach().clone() for k, v in shard.extract_params(scene).items()}, loss

        render.render_image, shard.sharded_train_step = stale_render, stale_step
    elif kind == "half":
        def half_render(config, **kw):
            half = dataclasses.replace(config,
                                       samples_per_pixel=max(1, config.samples_per_pixel // 2))
            img, accum = real_render(half, **kw)
            return img, accum

        def half_step(scene, camera, target, width, height, spp, *args, **kw):
            return real_step(scene, camera, target, width, height, max(1, spp // 2), *args, **kw)

        render.render_image, shard.sharded_train_step = half_render, half_step
    elif kind == "alter":
        real_compact, real_replay = render.trace_paths_compact, shard.trace_paths_replay_fast

        def alter_compact(*args, **kw):
            rad, overflow = real_compact(*args, **kw)
            return _zero_every_16th(rad), overflow

        def alter_replay(*args, **kw):
            return _zero_every_16th(real_replay(*args, **kw))

        render.trace_paths_compact, shard.trace_paths_replay_fast = alter_compact, alter_replay
    elif kind == "stale_late":
        from benchmark.jobs.train_steps import CHECKED_STEPS

        calls = []

        def stale_late_step(scene, *args, **kw):
            new, loss = real_step(scene, *args, **kw)
            calls.append(1)
            if len(calls) > CHECKED_STEPS:
                new = {k: v.detach().clone()
                       for k, v in shard.extract_params(scene).items()}
            return new, loss

        shard.sharded_train_step = stale_late_step
    elif kind == "geometry":
        def geometry_step(scene, *args, **kw):
            new, loss = real_step(scene, *args, **kw)
            old = shard.extract_params(scene)
            return dict(new, c0=old["c0"].detach().clone(),
                        radius=old["radius"].detach().clone()), loss

        shard.sharded_train_step = geometry_step
    else:
        raise ValueError(f"unknown fault {kind!r}; have {FAULTS}")
    try:
        yield
    finally:
        for (mod, attr), fn in saved.items():
            setattr(mod, attr, fn)
