#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (rtweekend_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, each printed as one JSON line:
  1. device    card, power limit, torch/CUDA versions, kernel build time
               and every instantiation's ptxas registers and spills;
  2. kernel    the hand-written bounce kernel against its plain PyTorch
               version on the card: 65,536 camera rays (one segment of 8
               bounces) of final_scene, cornell_box and the scenes of the
               noise (two_perlin_spheres, simple_light), image (earth) and
               gradient-sky (golden_scene) variants; then every segment of
               one sample batch of the main path at its own shape, for
               final_scene 1200x675 and for golden_scene, two_perlin_spheres,
               simple_light and earth at 600x400 (each variant's ms/launch
               and bound);
  3. compact   compacted driver bit-equal to the uncompacted kernel; an
               over-tight schedule raises the overflow flag, and the render
               driver recovers it;
  4. render    a small render through the kernel against the same render
               through the plain version (channel means);
  5. main      render_image of final_scene at 1200x675, depth 50, through
               the normal entry point, with the kernel's launch count;
               the image goes to smoke_out/;
  6. profile   the main path once more under torch.profiler: device time
               by kernel and the card's idle share;
  7. scenes    render_image of every scene at its own default size, depth
               50, 16 spp, through the normal entry point on the default
               device: wall seconds, primary rays/s, launches of each
               variant, a PNG in smoke_out/;
  8. winners_vs_plain  the kernel's want_winners variant against the
               plain version (final_scene, cornell_box, golden_scene,
               two_perlin_spheres; 65,536 rays, depth 8) on entries alive
               on both sides, radiance bit-equal to the radiance-only
               launch, ms/launch with and without winners;
  9. replay_vs_kernel  the differentiable replay's radiance on kernel
               winners against the kernel's own radiance;
 10. grad_vs_plain  loss gradients through kernel winners against
               gradients through plain winners: final_scene 64x36 under its
               flat sky, golden_scene 60x40 under its own gradient sky
               (2 spp, depth 8);
 11. train     the training path: sharded_train_step on final_scene at
               1200x675, depth 50, 4 spp, one step (4 blocks of 810,000
               rays each), with the seconds of each pass, launches and peak
               memory; then one more step under torch.profiler;
 12. train_golden  sharded_train_step on golden_scene at 600x400, 4 spp,
               depth 50, 2 steps (one block of 960,000 rays) under its own
               sky, with nonzero c0, radius and albedo gradients; then one
               more step under torch.profiler.
Then the `kernels` line and, last, the result line. Any failed check
raises and the script exits non-zero; without a card it exits non-zero
before printing any result. Imports nothing of JAX or rtweekend_tpu.

Bars (from tests/test_pallas.py:52-102): at most 0.5% of radiance lanes
off by more than 1e-3, channel means within 2% (plus atol 5e-3 for the
texture scenes and for the main path's late segments); winners: at most 0.5% of
live entries differ; replay vs kernel: at most 1% of elements off by a
relative 1e-3 (tests/test_replay.py:58-59), channel means within 2%;
gradients through kernel winners against gradients through plain winners:
on the rays whose winners agree on every bounce (the same paths),
relative L2 <= 1e-4 per parameter group; over all rays, where the <=0.5%
of diverged rays add different paths, the albedo gradient of the MSE
loss within relative L2 1e-2 (flat sky), the rest reported; under the
gradient sky the c0 and radius gradients must be nonzero. Discrete decisions
(closest root, Schlick draw, checker sign) can flip on rays whose
candidate t differ in the last bits between the two summation orders;
such a ray's path then legitimately diverges, hence a statistical bar.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

OUT_DIR = "smoke_out"
DEVICE = "cuda"
CMP_SIDE = 256      # kernel vs plain on CMP_SIDE**2 = 65,536 camera rays
MAIN_W, MAIN_H, MAIN_SPP, MAIN_DEPTH = 1200, 675, 16, 50
TRAIN_SPP, TRAIN_STEPS, TRAIN_CHUNK = 4, 1, 1 << 20
GOLDEN_STEPS = 2
GRAD_W, GRAD_H, GRAD_SPP, GRAD_DEPTH = 64, 36, 2, 8
GOLDEN_GRAD_W, GOLDEN_GRAD_H = 60, 40
SCENES_SPP = 16
LANE_TOL, LANE_FRAC, MEAN_RTOL, TEX_MEAN_ATOL = 1e-3, 0.005, 0.02, 5e-3
REPLAY_FRAC, GRAD_RTOL, SAME_PATH_RTOL = 0.01, 1e-2, 1e-4
# the kernel variant each added scene exercises, and its means atol
# (tests/test_pallas.py:90-102 for the texture scenes; golden_scene takes
# final_scene's bar)
VARIANT_SCENES = (("two_perlin_spheres", "noise", TEX_MEAN_ATOL),
                  ("simple_light", "noise", TEX_MEAN_ATOL),
                  ("earth", "image", TEX_MEAN_ATOL),
                  ("golden_scene", "sky", 0.0))
# scenes lit only by their lights: the darkness check is scaled down
LIGHT_ONLY = ("simple_light", "cornell_box")
# H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor cores, HBM
FP32_FLOPS = 67e12
HBM_BYTES_S = 3.35e12
# arithmetic operations of the texture work per live hit (noise, image)
# and of the gradient sky per live miss, counted from csrc/megakernel.cu
# (its source note lists the terms)
NOISE_OPS, IMAGE_OPS, SKY_OPS = 1338, 118, 15


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def gpu_ms(fn, reps):
    """Mean milliseconds of fn() over reps runs, by CUDA events (after one
    warm-up run)."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(kernel_rad, plain_rad, what, mean_atol=0.0):
    """Hold kernel radiance [3, n] against the plain version's: the lane
    bar, and channel means within MEAN_RTOL (+ mean_atol)."""
    import torch

    diff = (kernel_rad - plain_rad).abs()
    frac = (diff > LANE_TOL).float().mean().item()
    km = kernel_rad.double().mean(1)
    pm = plain_rad.double().mean(1)
    rel = ((km - pm).abs() / pm.abs().clamp(min=1e-12)).max().item()
    check(torch.isfinite(kernel_rad).all().item(), f"{what}: non-finite kernel radiance")
    check(frac < LANE_FRAC, f"{what}: {frac:.5f} of lanes off by > {LANE_TOL}")
    check(bool(((km - pm).abs() <= mean_atol + MEAN_RTOL * pm.abs()).all()),
          f"{what}: channel means {km.tolist()} vs {pm.tolist()}")
    return dict(max_abs=diff.max().item(), diverged_frac=frac, mean_rel=rel,
                kernel_means=km.tolist(), plain_means=pm.tolist())


def segment_bound(tables, scene, state, seed, bg, b0, n_b, mk, out_bytes=0):
    """Least time (ms) the card could take for this segment's work on this
    data, over the scene's real primitives (the padding of the packed
    tables left out): the coefficient march of every live ray-bounce (17
    multiply-adds per coefficient row, 2 FLOP each, over the 2S+6R real
    rows, plus the 2-FLOP discriminant per real sphere), the noise and
    image texture work of every live hit on such a texture and the
    gradient sky of every live miss, at the fp32 peak; or the state read
    and written once, the real rows of the tables read once (17 features
    per coefficient row, 34 attributes per primitive, the 6 KB Perlin
    tables and the texel atlas where the variant reads them), plus
    `out_bytes` of other outputs, at the HBM rate; whichever is larger.
    Live rays and their hits are counted by stepping the kernel's winners
    variant one bounce at a time (not part of the main path's counts,
    which are reset before each main path)."""
    import numpy as np

    ns = int(scene.spheres.active.sum().item())
    nr = int(scene.rects.active.sum().item())
    rows = 2 * ns + 6 * nr
    flop_per_rb = 2 * 17 * rows + 2 * ns
    has_sky = np.asarray(bg).ndim == 2
    ttype = tables.attr_i[mk._AI_TTYPE]
    live_rb = noise_hits = image_hits = live_misses = 0
    st = state
    for k in range(n_b):
        live = st[:, mk.S_AL] > 0.5
        live_rb += int(live.sum().item())
        _, st, win = mk.trace_segment(tables, st, seed, bg, b0 + k, 1, want_winners=True)
        w = win[0]
        tt = ttype[w.clamp(min=0).long()]
        noise_hits += int(((w >= 0) & (tt == mk.TEX_NOISE)).sum().item())
        image_hits += int(((w >= 0) & (tt == mk.TEX_IMAGE)).sum().item())
        live_misses += int((live & (w < 0)).sum().item())
    ops = (live_rb * flop_per_rb + noise_hits * NOISE_OPS * tables.has_noise
           + image_hits * IMAGE_OPS * tables.has_image + live_misses * SKY_OPS * has_sky)
    m = state.shape[0]
    table_bytes = (rows * 17 + (29 + 5) * (ns + nr)) * 4
    table_bytes += 2 * 768 * 4 if tables.has_noise else 0
    texels = int((scene.image_w.long() * scene.image_h.long()).sum().item())
    table_bytes += texels * 4 if tables.has_image else 0
    nbytes = out_bytes + (2 * m * 14 + 3 * m) * 4 + table_bytes
    return dict(spheres=ns, rects=nr, live_ray_bounces=live_rb, noise_hits=noise_hits,
                image_hits=image_hits, live_misses=live_misses,
                ops_ms=ops / FP32_FLOPS * 1e3,
                bytes_ms=nbytes / HBM_BYTES_S * 1e3)


def timed(fn):
    """(fn(), milliseconds of that one call by CUDA events)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def alive_steps(fn, tables, state, bg, depth, mk):
    """[depth, m] bool: which rays are alive entering each bounce, by
    stepping fn (the kernel wrapper or the plain version) one bounce at a
    time."""
    import torch

    alive = []
    for b in range(depth):
        alive.append(state[:, mk.S_AL] > 0.5)
        _, state = fn(tables, state, 42, bg, b, 1)
    return torch.stack(alive)


def winners_check(mk, tables, state, bg, depth, what):
    """The want_winners variant against the radiance-only launch (radiance
    and state bit-equal) and against the plain version (winners on the
    entries alive on both sides, radiance by compare()). Returns (kernel
    radiance [3, m], kernel winners, plain ms, report)."""
    import torch

    rk, sk, wk = mk.trace_segment(tables, state, 42, bg, 0, depth, want_winners=True)
    r0, s0 = mk.trace_segment(tables, state, 42, bg, 0, depth)
    (rp, _, wp), plain_ms = timed(
        lambda: mk.trace_segment_plain(tables, state, 42, bg, 0, depth, want_winners=True))
    check(torch.equal(rk, r0) and torch.equal(sk, s0),
          f"{what}: want_winners changed the radiance or the state")
    n_prims = tables.s_pad + tables.r_pad
    check(tuple(wk.shape) == (depth, state.shape[0]) and wk.dtype == torch.int32,
          f"{what}: winners {tuple(wk.shape)} {wk.dtype}")
    check(bool(((wk >= -1) & (wk < n_prims)).all()), f"{what}: winner index out of range")
    alive_k = alive_steps(mk.trace_segment, tables, state, bg, depth, mk)
    alive_p = alive_steps(mk.trace_segment_plain, tables, state, bg, depth, mk)
    check(bool((wk[~alive_k] == -1).all()), f"{what}: a dead ray's winner is not -1")
    live = alive_k & alive_p
    differ = (wk[live] != wp[live]).float().mean().item()
    check(differ <= LANE_FRAC, f"{what}: {differ:.5f} of live winner entries differ")
    res = compare(rk, rp, what)
    del rp, wp
    return rk, wk, plain_ms, dict(live_entries=int(live.sum().item()),
                                  winners_differ_frac=differ, **res)


def rel_l2(a, b):
    import torch

    nb = torch.linalg.norm(b.double()).item()
    diff = torch.linalg.norm((a - b).double()).item()
    return diff / nb if nb > 0 else diff


def profile_fn(fn, **meta):
    """fn() once under torch.profiler: device time by kernel, device busy
    and idle share of the host-clock wall time. Reports "not measured"
    when the profiler sees no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def self_dev_us(ev):
        return getattr(ev, "self_device_time_total", None) or \
            getattr(ev, "self_cuda_time_total", 0)

    # device-side events only: a host op (aten::index_add_) also reports
    # the device time of the kernels it launched
    kern = sorted(((self_dev_us(ev), ev.key) for ev in prof.key_averages()
                   if ev.device_type == torch.autograd.DeviceType.CUDA
                   and self_dev_us(ev) > 0), reverse=True)
    busy_ms = sum(us for us, _ in kern) / 1e3
    if busy_ms == 0:
        return dict(**meta, wall_ms=wall * 1e3,
                    device_busy_ms="not measured", idle_share="not measured")
    bounce_ms = sum(us for us, k in kern if "bounce_kernel" in k) / 1e3
    return dict(**meta, wall_ms=wall * 1e3, device_busy_ms=busy_ms,
                idle_share=1.0 - busy_ms / (wall * 1e3), bounce_kernel_ms=bounce_ms,
                n_kernel_names=len(kern),
                top_kernels=[[k[:80], us / 1e3] for us, k in kern[:10]])


def main() -> int:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 2
    import rtweekend_tpu_torch  # noqa: F401  (sets fp32 matmul policy)
    from rtweekend_tpu_torch.config import SCENE_DEFAULTS, RenderConfig
    from rtweekend_tpu_torch.models import builders
    from rtweekend_tpu_torch.models.builders import build_scene
    from rtweekend_tpu_torch.ops.cuda import build
    from rtweekend_tpu_torch.ops.cuda import megakernel as mk
    from rtweekend_tpu_torch import render as render_mod
    from rtweekend_tpu_torch.grad import make_loss
    from rtweekend_tpu_torch.ops.camera import generate_rays
    from rtweekend_tpu_torch.ops.cuda import vjp
    from rtweekend_tpu_torch.ops.replay import trace_paths_replay_fast
    from rtweekend_tpu_torch.parallel import shard
    from rtweekend_tpu_torch.utils import image as image_mod

    for mod in list(sys.modules):
        check(not (mod == "jax" or mod.startswith("jax.") or mod == "rtweekend_tpu"
                   or mod.startswith("rtweekend_tpu.")), f"imported {mod}")
    os.makedirs(OUT_DIR, exist_ok=True)
    dev = torch.device(DEVICE)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    card = smi

    # ---- 1. device + kernel build ----
    _, built = build.load()
    ptxas = [ln.strip() for ln in built.log.splitlines()
             if "entry function" in ln or "registers" in ln or "spill" in ln]
    # earth's texture (and with it the image variant's work) depends on
    # whether the texture file is present
    earth_tex = (f"file {builders.EARTH_TEXTURE_PATH}"
                 if os.path.exists(builders.EARTH_TEXTURE_PATH) else "procedural")
    emit("device", name=kind, nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, kernel_lib=os.path.relpath(built.path),
         build_s=built.seconds, earth_texture=earth_tex, ptxas=ptxas)
    print(smi, flush=True)

    def rays(name, side, aspect, n):
        """n camera rays over a side x side pixel grid, samples 0, 1, ..."""
        cam = render_mod.camera_for_scene(name, aspect, dev)
        ids = torch.arange(n, dtype=torch.int32, device=dev)
        pid = ids % (side * side)
        sid = torch.div(ids, side * side, rounding_mode="floor")
        return (*generate_rays(cam, side, side, pid, sid, 42), pid, sid)

    def aspect_of(name):
        p = SCENE_DEFAULTS[name]
        return p["width"] / p["height"]

    # ---- 2. kernel vs plain ----
    cmp_scenes = [("final_scene", 16 / 9, 0.0), ("cornell_box", 1.0, 0.0)] + [
        (name, aspect_of(name), atol) for name, _, atol in VARIANT_SCENES]
    for name, aspect, atol in cmp_scenes:
        depth = 8
        scene = build_scene(name, device=dev)
        tables = mk.pack_scene(scene)
        bg = SCENE_DEFAULTS[name]["background"]
        o, d, t, pid, sid = rays(name, CMP_SIDE, aspect, CMP_SIDE * CMP_SIDE)
        args = (tables, o, d, t, pid, sid, 42, bg, depth)
        rk = mk.trace_paths(*args, kernel="cuda")
        rp = mk.trace_paths(*args, kernel="torch")
        torch.cuda.synchronize()
        res = compare(rk.t(), rp.t(), f"{name} {CMP_SIDE ** 2} rays depth {depth}",
                      mean_atol=atol)
        bnd = segment_bound(tables, scene, mk.init_state(o, d, t, pid, sid), 42, bg, 0,
                            depth, mk)
        emit("kernel_vs_plain", scene=name, rays=CMP_SIDE ** 2, depth=depth, **res,
             kernel_ms=gpu_ms(lambda: mk.trace_paths(*args, kernel="cuda"), 5),
             plain_ms=gpu_ms(lambda: mk.trace_paths(*args, kernel="torch"), 2),
             **bnd, bound_ms=max(bnd["ops_ms"], bnd["bytes_ms"]), card=card)

    def main_segments(name, width, height):
        """Every segment of one sample batch (1 spp) of the scene's render
        at width x height, kernel against plain at its own shape."""
        scene = build_scene(name, device=dev)
        tables = mk.pack_scene(scene)
        bg = SCENE_DEFAULTS[name]["background"]
        cam = render_mod.camera_for_scene(name, width / height, dev)
        o, d, t, pid, sid = render_mod._gen_batch_rays(
            cam, 42, 0, width=width, height=height, n_samples=1)
        n = o.shape[0]
        state = mk.init_state(o, d, t, pid, sid)
        count = torch.tensor(n, device=dev)
        segs = []
        for b0, n_b, out_cap in mk.schedule(n, MAIN_DEPTH, render_mod._capacities_for(bg)):
            if out_cap < state.shape[0]:
                state, ovf = mk.compact(state, count, out_cap)
                check(not ovf.item(), f"{name} main-path schedule overflowed at bounce {b0}")
            rk, sk = mk.trace_segment(tables, state, 42, bg, b0, n_b)
            rp, sp = mk.trace_segment_plain(tables, state, 42, bg, b0, n_b)
            torch.cuda.synchronize()
            # late segments hold a few thousand live rays, whose mean radiance
            # is ~1e-4: the means bar gets test_pallas.py:89-91's atol 5e-3
            res = compare(rk, rp, f"{name} main-path segment b0={b0} x{n_b} cap={out_cap}",
                          mean_atol=TEX_MEAN_ATOL)
            # alive fractions are reported, not held to a bar: the rays still
            # alive after bounce 20 are trapped between glass and metal, where
            # a last-bit difference grows into a different path within the
            # segment's 30 bounces; their radiance is held by compare() above
            alive_k = (sk[:, mk.S_AL] > 0.5).float().mean().item()
            alive_p = (sp[:, mk.S_AL] > 0.5).float().mean().item()
            k_ms = gpu_ms(lambda: mk.trace_segment(tables, state, 42, bg, b0, n_b), 3)
            p_ms = gpu_ms(lambda: mk.trace_segment_plain(tables, state, 42, bg, b0, n_b), 1)
            bnd = segment_bound(tables, scene, state, 42, bg, b0, n_b, mk)
            seg = dict(b0=b0, bounces=n_b, cap=out_cap, **bnd, kernel_ms=k_ms, plain_ms=p_ms,
                       bound_ms=max(bnd["ops_ms"], bnd["bytes_ms"]),
                       alive_out=alive_k, alive_out_plain=alive_p, max_abs=res["max_abs"],
                       diverged_frac=res["diverged_frac"])
            segs.append(seg)
            emit("kernel_vs_plain_main_segment", scene=name, width=width, height=height,
                 **seg, card=card)
            state = sk
            count = (state[:, mk.S_AL] > 0.5).sum()
        return segs

    # every segment of one sample batch of each main path, at its own shape
    segs = main_segments("final_scene", MAIN_W, MAIN_H)
    variant_segs = {"sky": [], "noise": [], "image": []}
    for name, v in (("golden_scene", "sky"), ("two_perlin_spheres", "noise"),
                    ("simple_light", "noise"), ("earth", "image")):
        variant_segs[v] += main_segments(name, SCENE_DEFAULTS[name]["width"],
                                         SCENE_DEFAULTS[name]["height"])
    scene = build_scene("final_scene", device=dev)
    tables = mk.pack_scene(scene)
    bg = SCENE_DEFAULTS["final_scene"]["background"]

    # ---- 3. compaction on the card ----
    o, d, t, pid, sid = rays("final_scene", 32, 16 / 9, 2500)
    full = mk.trace_paths(tables, o, d, t, pid, sid, 42, bg, 9, kernel="cuda")
    comp, ovf = mk.trace_paths_compact(tables, o, d, t, pid, sid, 42, bg, 9,
                                       capacities=((1, 0.9), (3, 0.5), (6, 0.3)),
                                       kernel="cuda")
    check(not ovf.item(), "compaction overflowed on a roomy schedule")
    check(torch.equal(comp, full), "compacted != uncompacted")
    cb = build_scene("cornell_box", device=dev)
    ctab = mk.pack_scene(cb)
    ccam = render_mod.camera_for_scene("cornell_box", 1.0, dev)
    o, d, t, pid, sid = rays("cornell_box", 32, 1.0, 4096)
    _, ovf = mk.trace_paths_compact(ctab, o, d, t, pid, sid, 42, (0.0, 0.0, 0.0), 6,
                                    capacities=((2, 0.1),), kernel="cuda")
    check(bool(ovf.item()), "over-tight schedule did not raise the overflow flag")
    fb = render_mod.render(cb, ccam, 16, 16, 4, 6, (0.0, 0.0, 0.0), 42,
                           capacities=((2, 0.1),), kernel="cuda")
    want = render_mod.render(cb, ccam, 16, 16, 4, 6, (0.0, 0.0, 0.0), 42,
                             capacities=(), kernel="cuda")
    check(torch.allclose(fb, want, rtol=1e-5, atol=1e-6), "overflow recovery differs")
    emit("compact", bit_equal=True, rays=2500, depth=9, overflow_flag=True,
         recovered=True)

    # ---- 4. small render, kernel vs plain ----
    cfg = RenderConfig(scene="final_scene", width=96, height=54, samples_per_pixel=4,
                       max_depth=12)
    img_k, acc_k = render_mod.render_image(cfg, device=dev, kernel="cuda")
    img_p, acc_p = render_mod.render_image(cfg, device=dev, kernel="torch")
    mk_means = acc_k.reshape(-1, 3).double().mean(0)
    mp_means = acc_p.reshape(-1, 3).double().mean(0)
    rel = ((mk_means - mp_means).abs() / mp_means).max().item()
    check(rel < MEAN_RTOL, f"small render means {mk_means.tolist()} vs {mp_means.tolist()}")
    emit("render_vs_plain", scene="final_scene", size="96x54", spp=4, depth=12,
         mean_rel=rel, shape=list(img_k.shape))

    # ---- 5. main path ----
    cfg = RenderConfig(scene="final_scene", width=MAIN_W, height=MAIN_H,
                       samples_per_pixel=MAIN_SPP, max_depth=MAIN_DEPTH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mk.reset_launch_counts()
    t0 = time.perf_counter()
    img, accum = render_mod.render_image(cfg)   # default device: the card
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = mk.launch_counts()
    launches = counts["launches"]
    check(launches > 0, "main path launched no bounce kernel")
    check(counts["winners_launches"] == 0, "the render path launched winners")
    check(accum.shape == (MAIN_H, MAIN_W, 3) and img.shape == (MAIN_H, MAIN_W, 3),
          f"shape {tuple(accum.shape)}")
    check(bool(torch.isfinite(accum).all().item()), "non-finite framebuffer")
    check(float(accum.mean().item()) > 0.1 * MAIN_SPP, "framebuffer implausibly dark")
    png = os.path.join(OUT_DIR, "chip_smoke_final_scene.png")
    image_mod.write_png(png, img)
    emit("main", scene="final_scene", width=MAIN_W, height=MAIN_H, spp=MAIN_SPP,
         depth=MAIN_DEPTH, wall_s=wall, primary_rays_per_s=MAIN_W * MAIN_H * MAIN_SPP / wall,
         launches=launches, peak_mem_bytes=torch.cuda.max_memory_allocated(),
         png=png, card=card)

    # ---- 6. where the main path's device time goes ----
    emit("profile", **profile_fn(lambda: render_mod.render_image(RenderConfig(
        scene="final_scene", width=MAIN_W, height=MAIN_H, samples_per_pixel=4,
        max_depth=MAIN_DEPTH)), spp=4), card=card)

    # ---- 7. every scene through the normal entry point ----
    variant_launches = {"noise": 0, "image": 0, "sky": 0}
    for name, p in SCENE_DEFAULTS.items():
        cfg = RenderConfig(scene=name, width=p["width"], height=p["height"],
                           samples_per_pixel=SCENES_SPP, max_depth=MAIN_DEPTH)
        torch.cuda.synchronize()
        mk.reset_launch_counts()
        t0 = time.perf_counter()
        img, accum = render_mod.render_image(cfg)   # default device: the card
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = mk.launch_counts()
        for v in variant_launches:
            variant_launches[v] += counts[f"{v}_launches"]
        check(counts["launches"] > 0, f"{name}: no bounce kernel launched")
        for scene_name, v, _ in VARIANT_SCENES:
            if scene_name == name:
                check(counts[f"{v}_launches"] == counts["launches"],
                      f"{name}: not every launch was the {v} variant")
        check(accum.shape == (cfg.height, cfg.width, 3), f"{name}: shape {tuple(accum.shape)}")
        check(bool(torch.isfinite(accum).all().item()), f"{name}: non-finite framebuffer")
        floor = (0.02 if name in LIGHT_ONLY else 0.1) * SCENES_SPP
        check(float(accum.mean().item()) > floor, f"{name}: framebuffer implausibly dark")
        png = os.path.join(OUT_DIR, f"chip_smoke_{name}.png")
        image_mod.write_png(png, img)
        emit("scenes", scene=name, width=cfg.width, height=cfg.height, spp=SCENES_SPP,
             depth=MAIN_DEPTH, wall_s=wall,
             primary_rays_per_s=cfg.width * cfg.height * SCENES_SPP / wall,
             mean_radiance=float(accum.mean().item()) / SCENES_SPP, **counts, png=png,
             card=card)

    # ---- 8. winners variant vs plain ----
    for name, depth in (("final_scene", 8), ("cornell_box", 8), ("golden_scene", 8),
                        ("two_perlin_spheres", 8)):
        wscene = build_scene(name, device=dev)
        wtab = mk.pack_scene(wscene)
        wbg = SCENE_DEFAULTS[name]["background"]
        aspect = 1.0 if name == "cornell_box" else aspect_of(name)
        wrays = rays(name, CMP_SIDE, aspect, CMP_SIDE * CMP_SIDE)
        wstate = mk.init_state(*wrays)
        rk, wk, _, res = winners_check(mk, wtab, wstate, wbg, depth,
                                       f"{name} {CMP_SIDE ** 2} rays depth {depth} winners")
        emit("winners_vs_plain", scene=name, rays=CMP_SIDE ** 2, depth=depth, **res,
             kernel_ms_winners=gpu_ms(lambda: mk.trace_segment(
                 wtab, wstate, 42, wbg, 0, depth, want_winners=True), 5),
             kernel_ms_radiance_only=gpu_ms(lambda: mk.trace_segment(
                 wtab, wstate, 42, wbg, 0, depth), 5), card=card)
        if name == "final_scene":
            keep = (wscene, wbg, wrays, rk, wk)

    # ---- 9. replay on kernel winners vs the kernel's radiance ----
    wscene, wbg, wrays, rk, wk = keep
    n = wrays[0].shape[0]
    with torch.no_grad():
        rep = trace_paths_replay_fast(wscene, *wrays, 42, wbg, wk[:, :n])
    ker = rk[:, :n].t()
    rel = (rep - ker).abs() / (ker.abs() + 1e-3)
    frac = (rel > 1e-3).float().mean().item()
    km, rm = ker.double().mean(0), rep.double().mean(0)
    check(bool(torch.isfinite(rep).all()), "replay radiance not finite")
    check(frac <= REPLAY_FRAC, f"replay vs kernel: {frac:.5f} of elements off by 1e-3")
    check(bool(((rm - km).abs() <= MEAN_RTOL * km.abs()).all()),
          f"replay means {rm.tolist()} vs kernel {km.tolist()}")

    def replay_fwd():
        with torch.no_grad():
            trace_paths_replay_fast(wscene, *wrays, 42, wbg, wk[:, :n])

    emit("replay_vs_kernel", scene="final_scene", rays=n, depth=8, off_frac=frac,
         max_abs=(rep - ker).abs().max().item(), replay_means=rm.tolist(),
         kernel_means=km.tolist(), replay_forward_ms=gpu_ms(replay_fwd, 3), card=card)
    del keep, rep, ker, rk, wk

    # ---- 10. gradients through kernel winners vs plain winners ----
    def grad_check(name, width, height):
        """Loss gradients through kernel winners against plain winners, each
        scene under its own sky."""
        gscene = build_scene(name, device=dev)
        gcam = render_mod.camera_for_scene(name, width / height, dev)
        gbg = SCENE_DEFAULTS[name]["background"]
        grays = render_mod._gen_batch_rays(gcam, 42, 0, width=width, height=height,
                                           n_samples=GRAD_SPP)
        gtarget = torch.full((height, width, 3), 0.5, device=dev)
        wins = {kern: vjp.kernel_winners(gscene, *grays, 42, gbg, GRAD_DEPTH,
                                         kernel=kern)[1]
                for kern in ("cuda", "torch")}
        # rays whose kernel and plain winners agree on every bounce take the
        # same path on both sides; the others are the diverged rays that
        # winners_vs_plain counts
        same = (wins["cuda"] == wins["torch"]).all(0).float()

        def grads_through(kernel):
            """(MSE loss of the mean image, its grads, same-path loss grads)"""
            params = {k: v.detach().clone().requires_grad_(True)
                      for k, v in shard.extract_params(gscene).items()}
            plist = list(params.values())
            # the entry point: render_mean through make_loss
            full = make_loss(gscene, gcam, gtarget, gbg, 42, width=width, height=height,
                             spp=GRAD_SPP, max_depth=GRAD_DEPTH, kernel=kernel)(params)
            g_full = torch.autograd.grad(full, plist)
            rad = trace_paths_replay_fast(shard.merge_params(gscene, params), *grays, 42,
                                          gbg, wins[kernel])
            same_loss = (((rad - 0.5) ** 2).sum(1) * same).sum() / rad.shape[0]
            g_same = torch.autograd.grad(same_loss, plist)
            return full.item(), dict(zip(params, g_full)), dict(zip(params, g_same))

        sky_name = "gradient" if len(gbg) == 2 else "flat"
        lk, fk, sk_ = grads_through("cuda")
        lp, fp, sp_ = grads_through("torch")
        rel_full = {k: rel_l2(fk[k], fp[k]) for k in fk}
        rel_same = {k: rel_l2(sk_[k], sp_[k]) for k in sk_}
        for k in fk:
            check(bool(torch.isfinite(fk[k]).all() and torch.isfinite(sk_[k]).all()),
                  f"{name}: grad {k} not finite")
            check(rel_same[k] <= SAME_PATH_RTOL,
                  f"{name}: same-path grad {k}: relative L2 {rel_same[k]}")
        check(fk["color"].abs().sum().item() > 0, f"{name}: zero albedo gradient")
        if sky_name == "flat":
            check(rel_full["color"] <= GRAD_RTOL,
                  f"{name}: albedo grad: relative L2 {rel_full['color']} (flat sky)")
        else:
            for k in ("c0", "radius"):
                check(fk[k].abs().sum().item() > 0, f"{name}: zero {k} gradient under the sky")
        emit("grad_vs_plain", scene=name, size=f"{width}x{height}", spp=GRAD_SPP,
             depth=GRAD_DEPTH, sky=sky_name, diverged_rays=1.0 - same.mean().item(),
             loss_kernel=lk, loss_plain=lp, rel_l2_full=rel_full, rel_l2_same_path=rel_same,
             grad_l2={k: torch.linalg.norm(v.double()).item() for k, v in fk.items()},
             card=card)

    grad_check("final_scene", GRAD_W, GRAD_H)
    grad_check("golden_scene", GOLDEN_GRAD_W, GOLDEN_GRAD_H)

    # ---- the winners variant at the train step's pass-2 shape ----
    tcam = render_mod.camera_for_scene("final_scene", MAIN_W / MAIN_H, dev)
    o, d, t, pid, sid = render_mod._gen_batch_rays(tcam, 42, 0, width=MAIN_W,
                                                   height=MAIN_H, n_samples=1)
    pstate = mk.init_state(o, d, t, pid, sid)
    _, _, win_plain_ms, win_res = winners_check(
        mk, tables, pstate, bg, MAIN_DEPTH, f"pass-2 shape {pstate.shape[0]} lanes winners")
    win_ms = gpu_ms(lambda: mk.trace_segment(tables, pstate, 42, bg, 0, MAIN_DEPTH,
                                             want_winners=True), 3)
    rad_ms = gpu_ms(lambda: mk.trace_segment(tables, pstate, 42, bg, 0, MAIN_DEPTH), 3)
    win_bnd = segment_bound(tables, scene, pstate, 42, bg, 0, MAIN_DEPTH, mk,
                            out_bytes=MAIN_DEPTH * pstate.shape[0] * 4)
    emit("winners_pass2_shape", lanes=pstate.shape[0], depth=MAIN_DEPTH, **win_res,
         kernel_ms_winners=win_ms, kernel_ms_radiance_only=rad_ms, plain_ms=win_plain_ms,
         **win_bnd, card=card)
    del pstate, o, d, t, pid, sid
    torch.cuda.empty_cache()

    # ---- 11, 12. the training path at full width ----
    def train(name, width, height, steps, phase, check_geometry):
        """`steps` train steps from the albedo-perturbed scene towards the
        pass-1 mean image of the true scene, then one profiled step.
        Returns the launch counts of the timed steps."""
        tscene = build_scene(name, device=dev)
        tcam = render_mod.camera_for_scene(name, width / height, dev)
        tbg = SCENE_DEFAULTS[name]["background"]
        target = shard.kernel_mean_image(tscene, tcam, width, height, TRAIN_SPP, MAIN_DEPTH,
                                         tbg, 42, rays_per_chunk=TRAIN_CHUNK)
        p0 = shard.extract_params(tscene)
        tscene = shard.merge_params(tscene, dict(p0, color=p0["color"] * 0.8))  # albedo off
        train_kw = dict(lr=1.0, rays_per_chunk=TRAIN_CHUNK)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mk.reset_launch_counts()
        t0 = time.perf_counter()
        for step in range(steps):
            before_counts = mk.launch_counts()
            tm = {}
            ts = time.perf_counter()
            params, loss = shard.sharded_train_step(
                tscene, tcam, target, width, height, TRAIN_SPP, MAIN_DEPTH, tbg, 42,
                timings=tm, **train_kw)
            torch.cuda.synchronize()
            step_s = time.perf_counter() - ts
            counts = {k: v - before_counts[k] for k, v in mk.launch_counts().items()}
            before = shard.extract_params(tscene)
            grads = {k: before[k] - params[k] for k in params}   # lr = 1
            check(bool(torch.isfinite(loss).item()), f"{name} step {step}: loss not finite")
            for k, g in grads.items():
                check(bool(torch.isfinite(g).all()), f"{name} step {step}: grad {k} not finite")
            for k in ("c0", "radius", "color") if check_geometry else ("color",):
                check(grads[k].abs().sum().item() > 0, f"{name} step {step}: zero {k} gradient")
            emit(f"{phase}_step", scene=name, step=step, loss=loss.item(), wall_s=step_s, **tm,
                 launches_forward=counts["launches"] - counts["winners_launches"],
                 launches_winners=counts["winners_launches"],
                 launches_sky=counts["sky_launches"],
                 peak_mem_bytes=torch.cuda.max_memory_allocated(),
                 grad_l2={k: torch.linalg.norm(g.double()).item() for k, g in grads.items()},
                 card=card)
            tscene = shard.merge_params(tscene, params)
        wall = time.perf_counter() - t0
        counts = mk.launch_counts()
        check(counts["winners_launches"] > 0, f"{name}: the train path launched no winners")
        check(counts["launches"] - counts["winners_launches"] > 0,
              f"{name}: the train path launched no radiance kernel")
        emit(phase, scene=name, width=width, height=height, spp=TRAIN_SPP, depth=MAIN_DEPTH,
             steps=steps, rays_per_chunk=TRAIN_CHUNK, wall_s=wall, **counts,
             peak_mem_bytes=torch.cuda.max_memory_allocated(), card=card)
        emit(f"profile_{phase}", **profile_fn(lambda: shard.sharded_train_step(
            tscene, tcam, target, width, height, TRAIN_SPP, MAIN_DEPTH, tbg, 42, **train_kw),
            what="one train step"), card=card)
        torch.cuda.empty_cache()
        return counts

    train_counts = train("final_scene", MAIN_W, MAIN_H, TRAIN_STEPS, "train", False)
    golden_counts = train("golden_scene", SCENE_DEFAULTS["golden_scene"]["width"],
                          SCENE_DEFAULTS["golden_scene"]["height"], GOLDEN_STEPS,
                          "train_golden", True)
    check(golden_counts["sky_launches"] == golden_counts["launches"],
          "golden_scene: a train launch was not the sky variant")
    variant_launches["sky"] += golden_counts["sky_launches"]

    emit("total", seconds=time.perf_counter() - t_start)

    # ---- kernels line: per launch, averaged over the segments of one sample
    # batch of each scene the variant's main path was checked on ----
    def entry(name, launches, seg_list):
        ops_ms = sum(s["ops_ms"] for s in seg_list)
        bytes_ms = sum(s["bytes_ms"] for s in seg_list)
        k = len(seg_list)
        return {
            "name": name,
            "route": "cuda",
            "source": "rtweekend_tpu_torch/csrc/megakernel.cu",
            "replaces": "rtweekend_tpu/ops/pallas/megakernel.py:1050",
            "launches": launches,
            "max_abs_err": max(s["max_abs"] for s in seg_list),
            "ms": sum(s["kernel_ms"] for s in seg_list) / k,
            "plain_ms": sum(s["plain_ms"] for s in seg_list) / k,
            "bound_ms": sum(s["bound_ms"] for s in seg_list) / k,
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": None,
        }

    winners_entry = {
        "name": "megakernel_winners",
        "route": "cuda",
        "source": "rtweekend_tpu_torch/csrc/megakernel.cu",
        "replaces": "rtweekend_tpu/ops/pallas/megakernel.py:1050",
        "launches": train_counts["winners_launches"] + golden_counts["winners_launches"],
        "max_abs_err": win_res["max_abs"],
        "ms": win_ms,
        "plain_ms": win_plain_ms,
        "bound_ms": max(win_bnd["ops_ms"], win_bnd["bytes_ms"]),
        "bound_by": "operations" if win_bnd["ops_ms"] >= win_bnd["bytes_ms"] else "bytes",
        "library_ms": None,
    }
    print(json.dumps({"kernels": [
        entry("megakernel", launches, segs),
        winners_entry,
        entry("megakernel_noise", variant_launches["noise"], variant_segs["noise"]),
        entry("megakernel_image", variant_launches["image"], variant_segs["image"]),
        entry("megakernel_sky", variant_launches["sky"], variant_segs["sky"]),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
