"""Time the bounce kernel's general instantiation against the one a scene's
flags select, on the card, at every segment of one sample batch (1 spp)
of each scene's render at its default size:

    python -m rtweekend_tpu_torch.tools.instantiations [scene ...]

The general instantiation is reached by setting the packed tables'
has_motion flag: the moving-center lerp is exact on a static sphere (its
center delta is 0), so it computes the same function. Each segment is
timed by CUDA events, selected and general interleaved (A B B A) over
several rounds, radiance-only and with winners; the radiance and state
of the two are compared. One JSON line per segment and one summary line
per scene (sum over the segments of the mean ms of each side).
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys

import torch

from rtweekend_tpu_torch import render as render_mod
from rtweekend_tpu_torch.config import SCENE_DEFAULTS
from rtweekend_tpu_torch.models.builders import build_scene
from rtweekend_tpu_torch.ops.cuda import megakernel as mk

SCENES = ("two_perlin_spheres", "simple_light", "earth", "golden_scene", "cornell_box")
DEPTH, ROUNDS, REPS = 50, 4, 5


def _ms(fn, reps):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _ab(fa, fb):
    """Mean ms of fa and of fb, interleaved A B B A over ROUNDS rounds."""
    fa(), fb()
    a, b = [], []
    for r in range(ROUNDS):
        order = ((fa, a), (fb, b)) if r % 2 == 0 else ((fb, b), (fa, a))
        for fn, acc in order:
            acc.append(_ms(fn, REPS))
    return sum(a) / len(a), sum(b) / len(b)


def time_scene(name: str, card: str):
    dev = torch.device("cuda")
    p = SCENE_DEFAULTS[name]
    w, h, bg = p["width"], p["height"], p["background"]
    tables = mk.pack_scene(build_scene(name, device=dev))
    general = dataclasses.replace(tables, has_motion=True)
    cam = render_mod.camera_for_scene(name, w / h, dev)
    o, d, t, pid, sid = render_mod._gen_batch_rays(cam, 42, 0, width=w, height=h,
                                                   n_samples=1)
    state = mk.init_state(o, d, t, pid, sid)
    count = torch.tensor(o.shape[0], device=dev)
    tot = dict(selected=0.0, general=0.0, selected_w=0.0, general_w=0.0)
    for b0, n_b, cap in mk.schedule(o.shape[0], DEPTH, render_mod._capacities_for(bg)):
        if cap < state.shape[0]:
            state, _ = mk.compact(state, count, cap)
        rs, ss = mk.trace_segment(tables, state, 42, bg, b0, n_b)
        rg, sg = mk.trace_segment(general, state, 42, bg, b0, n_b)
        sel, gen = _ab(lambda: mk.trace_segment(tables, state, 42, bg, b0, n_b),
                       lambda: mk.trace_segment(general, state, 42, bg, b0, n_b))
        sel_w, gen_w = _ab(
            lambda: mk.trace_segment(tables, state, 42, bg, b0, n_b, want_winners=True),
            lambda: mk.trace_segment(general, state, 42, bg, b0, n_b, want_winners=True))
        for k, v in zip(tot, (sel, gen, sel_w, gen_w)):
            tot[k] += v
        print(json.dumps(dict(
            phase="instantiation_segment", scene=name, width=w, height=h, b0=b0,
            bounces=n_b, cap=cap, selected_ms=sel, general_ms=gen,
            selected_winners_ms=sel_w, general_winners_ms=gen_w,
            radiance_max_abs_diff=(rs - rg).abs().max().item(),
            state_equal=bool(torch.equal(ss, sg)), card=card)), flush=True)
        state = ss
        count = (state[:, mk.S_AL] > 0.5).sum()
    print(json.dumps(dict(phase="instantiation_scene", scene=name, width=w, height=h,
                          **{f"{k}_ms_sum": v for k, v in tot.items()},
                          general_over_selected=tot["general"] / tot["selected"],
                          general_over_selected_winners=tot["general_w"] / tot["selected_w"],
                          card=card)), flush=True)


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("instantiations: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    for name in (argv if argv else SCENES):
        time_scene(name, card)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
