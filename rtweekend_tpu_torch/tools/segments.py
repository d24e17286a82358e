"""Time the bounce kernel at every segment of one sample batch of each
render path, device time only, and hash what it writes:

    python rtweekend_tpu_torch/tools/segments.py [--root DIR] [--reps N] [scene ...]

Scenes: final_scene at 1200x675 and golden_scene, two_perlin_spheres,
simple_light and earth at their default sizes, each through the static
capacity schedule (`render._capacities_for`, which every checkout has, so
two checkouts time the same segments; render_image takes the measured
`adaptive_capacities`); `pass2`, final_scene's 811,008 lanes traced in one
launch at depth 50 (the train step's shape), radiance-only and with
winners; and `scan`, the same lanes for one bounce (every lane live: the
primitive scan at its widest). One JSON line per launch (b0, bounces, lanes, the launch shape
where the wrapper reports one, device ms and host ms per call by
utils/timing.device_ms, the sha256 of the radiance it adds onto a zero
total, its state and winners)
and one summary line per scene.

`--root` imports rtweekend_tpu_torch from another checkout instead of
this one (this file's timing helper is used either way), so that two
versions of the kernel can be timed in turns on one card, one process
each (A B B A), and their outputs compared by hash. `--groups` also
times every launch at each lane-group size G the wrapper can be forced
to (its `_group` keyword) and checks that each G writes the same bytes.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
SCENES = ("final_scene", "golden_scene", "two_perlin_spheres", "simple_light", "earth",
          "pass2", "scan")
MAIN_W, MAIN_H, DEPTH, SEED = 1200, 675, 50, 42


def _device_ms():
    spec = importlib.util.spec_from_file_location("_rtw_timing", _PKG / "utils" / "timing.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.device_ms


def digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", help="checkout to import rtweekend_tpu_torch from")
    ap.add_argument("--reps", type=int, default=20, help="launches timed per segment")
    ap.add_argument("--groups", action="store_true",
                    help="also time every launch at each forced lane-group size")
    ap.add_argument("scenes", nargs="*", default=list(SCENES))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve() if args.root else _PKG.parent))
    import torch

    if not torch.cuda.is_available():
        print("segments: no CUDA device", file=sys.stderr)
        return 2
    import rtweekend_tpu_torch
    from rtweekend_tpu_torch import render as render_mod
    from rtweekend_tpu_torch.config import SCENE_DEFAULTS
    from rtweekend_tpu_torch.models.builders import build_scene
    from rtweekend_tpu_torch.ops.camera import generate_rays
    from rtweekend_tpu_torch.ops.cuda import megakernel as mk

    device_ms = _device_ms()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    root = str(Path(rtweekend_tpu_torch.__file__).resolve().parents[1])
    print(json.dumps(dict(phase="segments_setup", root=root, card=card)), flush=True)
    dev = torch.device("cuda")

    def one(tables, state, cols, bg, b0, n_b, winners, reps):
        """Time one launch over `state`, whose ray ids lie below cols; returns
        ((total, state[, winners]) of the launch onto a zero total, row)."""
        def launch(total, g=None):
            return mk.trace_segment(tables, state, SEED, bg, b0, n_b, accum=total,
                                    want_winners=winners, _group=g)

        def fresh(g=None):
            total = torch.zeros((3, cols), device=dev)
            out = launch(total, g)
            return (total, *out) if winners else (total, out)

        out = fresh()
        scratch = torch.zeros((3, cols), device=dev)   # the timed launches add here
        ms, host_ms = device_ms(lambda: launch(scratch), reps)
        shape = getattr(mk.trace_segment, "last_shape", None)
        row = dict(b0=b0, bounces=n_b, lanes=state.shape[0], winners=winners,
                   shape=shape, ms=ms, host_ms=host_ms, sha=digest(*out))
        if args.groups:
            row["ms_by_group"] = {}
            for g in mk.GROUPS:
                if digest(*fresh(g)) != row["sha"]:
                    raise AssertionError(f"G={g} wrote other bytes at b0={b0}")
                row["ms_by_group"][g] = device_ms(lambda g=g: launch(scratch, g), reps)[0]
        return out, row

    for name in args.scenes:
        scene_name = "final_scene" if name in ("pass2", "scan") else name
        p = SCENE_DEFAULTS[scene_name]
        w, h = (MAIN_W, MAIN_H) if scene_name == "final_scene" else (p["width"], p["height"])
        bg = p["background"]
        tables = mk.pack_scene(build_scene(scene_name, device=dev))
        cam = render_mod.camera_for_scene(scene_name, w / h, dev)
        # sample 0 of every pixel, from the camera ops every checkout has
        pid = torch.arange(w * h, dtype=torch.int32, device=dev)
        sid = torch.zeros_like(pid)
        o, d, t = generate_rays(cam, w, h, pid, sid, SEED)
        state = mk.init_state(o, d, t, pid, sid)
        cols = state.shape[0]
        rows = []
        if name == "pass2":
            for winners in (False, True):
                _, row = one(tables, state, cols, bg, 0, DEPTH, winners, max(2, args.reps // 8))
                rows.append(row)
        elif name == "scan":
            rows.append(one(tables, state, cols, bg, 0, 1, False, args.reps)[1])
        else:
            count = torch.tensor(o.shape[0], device=dev)
            for b0, n_b, cap in mk.schedule(o.shape[0], DEPTH, render_mod._capacities_for(bg)):
                if cap < state.shape[0]:
                    state, _ = mk.compact(state, count, cap)
                out, row = one(tables, state, cols, bg, b0, n_b, False, args.reps)
                rows.append(row)
                state = out[1]
                count = (state[:, mk.S_AL] > 0.5).sum()
        for row in rows:
            print(json.dumps(dict(phase="segment", scene=name, width=w, height=h, **row,
                                  card=card)), flush=True)
        print(json.dumps(dict(phase="segments_scene", scene=name, launches=len(rows),
                              ms_sum=sum(r["ms"] for r in rows),
                              host_ms_sum=sum(r["host_ms"] for r in rows), card=card)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
