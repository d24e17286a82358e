#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (rtweekend_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, each printed as one JSON line:
  1. device    card, power limit, torch/CUDA versions, kernel build time;
  2. kernel    the hand-written bounce kernel against its plain PyTorch
               version on the card: 65,536 camera rays of final_scene and
               cornell_box (one segment of 8 bounces), then every segment
               of one sample batch of the main path at its own shape;
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
  7. winners_vs_plain  the kernel's want_winners variant against the
               plain version (final_scene, cornell_box; 65,536 rays, depth
               8) on entries alive on both sides, radiance bit-equal to the
               radiance-only launch, ms/launch with and without winners;
  8. replay_vs_kernel  the differentiable replay's radiance on kernel
               winners against the kernel's own radiance;
  9. grad_vs_plain  loss gradients through kernel winners against
               gradients through plain winners (final_scene 64x36, 2 spp,
               depth 8), flat sky and gradient-sky replay;
 10. train     the training path: sharded_train_step on final_scene at
               1200x675, depth 50, 4 spp, 2 steps (4 blocks of 810,000
               rays each), with the seconds of each pass, launches and peak
               memory; then one more step under torch.profiler.
Then the `kernels` line and, last, the result line. Any failed check
raises and the script exits non-zero; without a card it exits non-zero
before printing any result. Imports nothing of JAX or rtweekend_tpu.

Bars (from tests/test_pallas.py:52-69): at most 0.5% of radiance lanes
off by more than 1e-3, channel means within 2%; winners: at most 0.5% of
live entries differ; replay vs kernel: at most 1% of elements off by a
relative 1e-3 (tests/test_replay.py:58-59), channel means within 2%;
gradients through kernel winners against gradients through plain winners:
on the rays whose winners agree on every bounce (the same paths),
relative L2 <= 1e-4 per parameter group; over all rays, where the <=0.5%
of diverged rays add different paths, the albedo gradient of the MSE
loss within relative L2 1e-2 (flat sky), the rest reported. Discrete decisions
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
TRAIN_SPP, TRAIN_STEPS, TRAIN_CHUNK = 4, 2, 1 << 20
GRAD_W, GRAD_H, GRAD_SPP, GRAD_DEPTH = 64, 36, 2, 8
LANE_TOL, LANE_FRAC, MEAN_RTOL = 1e-3, 0.005, 0.02
REPLAY_FRAC, GRAD_RTOL, SAME_PATH_RTOL = 0.01, 1e-2, 1e-4
SKY = ((1.0, 1.0, 1.0), (0.5, 0.7, 1.0))   # golden_scene's gradient sky
# H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor cores, HBM
FP32_FLOPS = 67e12
HBM_BYTES_S = 3.35e12


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


def segment_bound(tables, state, seed, bg, b0, n_b, mk, out_bytes=0):
    """Least time (ms) the card could take for this segment's work on this
    data: the coefficient march of every live ray-bounce (17 multiply-adds
    per coefficient row, 2 FLOP each, plus the 2-FLOP discriminant per
    sphere) at the fp32 peak, or the state and tables read and written
    once (plus `out_bytes` of other outputs) at the HBM rate, whichever is
    larger. Live rays are counted by stepping the kernel one bounce at a
    time (not part of the main path's count, which is reset before the
    main path)."""
    rows = tables.coef.shape[0]
    flop_per_rb = 2 * 17 * rows + 2 * tables.s_pad
    live_rb = 0
    st = state
    for k in range(n_b):
        live_rb += int((st[:, mk.S_AL] > 0.5).sum().item())
        _, st = mk.trace_segment(tables, st, seed, bg, b0 + k, 1)
    m = state.shape[0]
    nbytes = out_bytes + (2 * m * 14 + 3 * m) * 4 + sum(
        t.numel() * t.element_size() for t in (tables.coef, tables.attr_f, tables.attr_i))
    return dict(live_ray_bounces=live_rb,
                ops_ms=live_rb * flop_per_rb / FP32_FLOPS * 1e3,
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
    emit("device", name=kind, nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, kernel_lib=os.path.relpath(built.path),
         build_s=built.seconds, ptxas=ptxas)
    print(smi, flush=True)

    def rays(name, side, aspect, n):
        """n camera rays over a side x side pixel grid, samples 0, 1, ..."""
        cam = render_mod.camera_for_scene(name, aspect, dev)
        ids = torch.arange(n, dtype=torch.int32, device=dev)
        pid = ids % (side * side)
        sid = torch.div(ids, side * side, rounding_mode="floor")
        return (*generate_rays(cam, side, side, pid, sid, 42), pid, sid)

    # ---- 2. kernel vs plain ----
    for name, depth in (("final_scene", 8), ("cornell_box", 8)):
        scene = build_scene(name, device=dev)
        tables = mk.pack_scene(scene)
        bg = SCENE_DEFAULTS[name]["background"]
        aspect = 16 / 9 if name == "final_scene" else 1.0
        o, d, t, pid, sid = rays(name, CMP_SIDE, aspect, CMP_SIDE * CMP_SIDE)
        args = (tables, o, d, t, pid, sid, 42, bg, depth)
        rk = mk.trace_paths(*args, kernel="cuda")
        rp = mk.trace_paths(*args, kernel="torch")
        torch.cuda.synchronize()
        res = compare(rk.t(), rp.t(), f"{name} {CMP_SIDE ** 2} rays depth {depth}")
        emit("kernel_vs_plain", scene=name, rays=CMP_SIDE ** 2, depth=depth, **res,
             kernel_ms=gpu_ms(lambda: mk.trace_paths(*args, kernel="cuda"), 5),
             plain_ms=gpu_ms(lambda: mk.trace_paths(*args, kernel="torch"), 2),
             card=card)

    # every segment of one sample batch of the main path, at its own shape
    scene = build_scene("final_scene", device=dev)
    tables = mk.pack_scene(scene)
    bg = SCENE_DEFAULTS["final_scene"]["background"]
    cam = render_mod.camera_for_scene("final_scene", MAIN_W / MAIN_H, dev)
    o, d, t, pid, sid = render_mod._gen_batch_rays(
        cam, 42, 0, width=MAIN_W, height=MAIN_H, n_samples=1)
    n = o.shape[0]
    state = mk.init_state(o, d, t, pid, sid)
    count = torch.tensor(n, device=dev)
    segs = []
    for b0, n_b, out_cap in mk.schedule(n, MAIN_DEPTH, render_mod._capacities_for(bg)):
        if out_cap < state.shape[0]:
            state, ovf = mk.compact(state, count, out_cap)
            check(not ovf.item(), f"main-path schedule overflowed at bounce {b0}")
        rk, sk = mk.trace_segment(tables, state, 42, bg, b0, n_b)
        rp, sp = mk.trace_segment_plain(tables, state, 42, bg, b0, n_b)
        torch.cuda.synchronize()
        # late segments hold a few thousand live rays, whose mean radiance
        # is ~1e-4: the means bar gets test_pallas.py:89-91's atol 5e-3
        res = compare(rk, rp, f"main-path segment b0={b0} x{n_b} cap={out_cap}",
                      mean_atol=5e-3)
        # alive fractions are reported, not held to a bar: the rays still
        # alive after bounce 20 are trapped between glass and metal, where
        # a last-bit difference grows into a different path within the
        # segment's 30 bounces; their radiance is held by compare() above
        alive_k = (sk[:, mk.S_AL] > 0.5).float().mean().item()
        alive_p = (sp[:, mk.S_AL] > 0.5).float().mean().item()
        k_ms = gpu_ms(lambda: mk.trace_segment(tables, state, 42, bg, b0, n_b), 3)
        p_ms = gpu_ms(lambda: mk.trace_segment_plain(tables, state, 42, bg, b0, n_b), 1)
        bnd = segment_bound(tables, state, 42, bg, b0, n_b, mk)
        seg = dict(b0=b0, bounces=n_b, cap=out_cap, **bnd, kernel_ms=k_ms, plain_ms=p_ms,
                   bound_ms=max(bnd["ops_ms"], bnd["bytes_ms"]),
                   alive_out=alive_k, alive_out_plain=alive_p, max_abs=res["max_abs"],
                   diverged_frac=res["diverged_frac"])
        segs.append(seg)
        emit("kernel_vs_plain_main_segment", **seg, card=card)
        state = sk
        count = (state[:, mk.S_AL] > 0.5).sum()

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
    mk.trace_segment.launches = 0
    mk.trace_segment.winners_launches = 0
    t0 = time.perf_counter()
    img, accum = render_mod.render_image(cfg)   # default device: the card
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = mk.trace_segment.launches
    check(launches > 0, "main path launched no bounce kernel")
    check(mk.trace_segment.winners_launches == 0, "the render path launched winners")
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

    # ---- 7. winners variant vs plain ----
    for name, depth in (("final_scene", 8), ("cornell_box", 8)):
        wscene = build_scene(name, device=dev)
        wtab = mk.pack_scene(wscene)
        wbg = SCENE_DEFAULTS[name]["background"]
        aspect = 16 / 9 if name == "final_scene" else 1.0
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

    # ---- 8. replay on kernel winners vs the kernel's radiance ----
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

    # ---- 9. gradients through kernel winners vs plain winners ----
    gscene = build_scene("final_scene", device=dev)
    gcam = render_mod.camera_for_scene("final_scene", GRAD_W / GRAD_H, dev)
    gbg = SCENE_DEFAULTS["final_scene"]["background"]
    grays = render_mod._gen_batch_rays(gcam, 42, 0, width=GRAD_W, height=GRAD_H,
                                       n_samples=GRAD_SPP)
    gn_pix = GRAD_W * GRAD_H
    gtarget = torch.full((GRAD_H, GRAD_W, 3), 0.5, device=dev)
    wins = {kern: vjp.kernel_winners(gscene, *grays, 42, gbg, GRAD_DEPTH, kernel=kern)[1]
            for kern in ("cuda", "torch")}
    # rays whose kernel and plain winners agree on every bounce take the
    # same path on both sides; the others are the diverged rays that
    # winners_vs_plain counts
    same = (wins["cuda"] == wins["torch"]).all(0).float()

    def grads_through(kernel, sky):
        """(MSE loss of the mean image, its grads, same-path loss grads)"""
        params = {k: v.detach().clone().requires_grad_(True)
                  for k, v in shard.extract_params(gscene).items()}
        plist = list(params.values())
        if sky is None:   # flat sky: the entry point, render_mean through make_loss
            full = make_loss(gscene, gcam, gtarget, gbg, 42, width=GRAD_W, height=GRAD_H,
                             spp=GRAD_SPP, max_depth=GRAD_DEPTH, kernel=kernel)(params)
            g_full = torch.autograd.grad(full, plist)
        rad = trace_paths_replay_fast(shard.merge_params(gscene, params), *grays, 42,
                                      gbg if sky is None else sky, wins[kernel])
        if sky is not None:   # flat-sky winners replayed under the gradient sky
            full = ((rad.reshape(gn_pix, GRAD_SPP, 3).mean(1) - 0.5) ** 2).mean()
            g_full = torch.autograd.grad(full, plist, retain_graph=True)
        same_loss = (((rad - 0.5) ** 2).sum(1) * same).sum() / rad.shape[0]
        g_same = torch.autograd.grad(same_loss, plist)
        return full.item(), dict(zip(params, g_full)), dict(zip(params, g_same))

    for sky_name, sky in (("flat", None), ("gradient", SKY)):
        lk, fk, sk_ = grads_through("cuda", sky)
        lp, fp, sp_ = grads_through("torch", sky)
        rel_full = {k: rel_l2(fk[k], fp[k]) for k in fk}
        rel_same = {k: rel_l2(sk_[k], sp_[k]) for k in sk_}
        for k in fk:
            check(bool(torch.isfinite(fk[k]).all() and torch.isfinite(sk_[k]).all()),
                  f"grad {k} not finite ({sky_name} sky)")
            check(rel_same[k] <= SAME_PATH_RTOL,
                  f"same-path grad {k}: relative L2 {rel_same[k]} ({sky_name} sky)")
        check(fk["color"].abs().sum().item() > 0, "zero albedo gradient")
        if sky is None:
            check(rel_full["color"] <= GRAD_RTOL,
                  f"albedo grad: relative L2 {rel_full['color']} (flat sky)")
        else:
            for k in ("c0", "radius"):
                check(fk[k].abs().sum().item() > 0, f"zero {k} gradient under the sky")
        emit("grad_vs_plain", scene="final_scene", size=f"{GRAD_W}x{GRAD_H}", spp=GRAD_SPP,
             depth=GRAD_DEPTH, sky=sky_name, diverged_rays=1.0 - same.mean().item(),
             loss_kernel=lk, loss_plain=lp, rel_l2_full=rel_full, rel_l2_same_path=rel_same,
             grad_l2={k: torch.linalg.norm(v.double()).item() for k, v in fk.items()},
             card=card)

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
    win_bnd = segment_bound(tables, pstate, 42, bg, 0, MAIN_DEPTH, mk,
                            out_bytes=MAIN_DEPTH * pstate.shape[0] * 4)
    emit("winners_pass2_shape", lanes=pstate.shape[0], depth=MAIN_DEPTH, **win_res,
         kernel_ms_winners=win_ms, kernel_ms_radiance_only=rad_ms, plain_ms=win_plain_ms,
         **win_bnd, card=card)
    del pstate, o, d, t, pid, sid
    torch.cuda.empty_cache()

    # ---- 10. the training path at full width ----
    tscene = build_scene("final_scene", device=dev)
    target = shard.kernel_mean_image(tscene, tcam, MAIN_W, MAIN_H, TRAIN_SPP, MAIN_DEPTH,
                                     bg, 42, rays_per_chunk=TRAIN_CHUNK)
    p0 = shard.extract_params(tscene)
    tscene = shard.merge_params(tscene, dict(p0, color=p0["color"] * 0.8))  # albedo off
    train_kw = dict(lr=1.0, rays_per_chunk=TRAIN_CHUNK)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mk.trace_segment.launches = 0
    mk.trace_segment.winners_launches = 0
    t0 = time.perf_counter()
    for step in range(TRAIN_STEPS):
        l0, w0 = mk.trace_segment.launches, mk.trace_segment.winners_launches
        tm = {}
        ts = time.perf_counter()
        params, loss = shard.sharded_train_step(
            tscene, tcam, target, MAIN_W, MAIN_H, TRAIN_SPP, MAIN_DEPTH, bg, 42,
            timings=tm, **train_kw)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - ts
        before = shard.extract_params(tscene)
        grads = {k: before[k] - params[k] for k in params}   # lr = 1
        check(bool(torch.isfinite(loss).item()), f"step {step}: loss not finite")
        for k, g in grads.items():
            check(bool(torch.isfinite(g).all()), f"step {step}: grad {k} not finite")
        check(grads["color"].abs().sum().item() > 0, f"step {step}: zero albedo gradient")
        emit("train_step", step=step, loss=loss.item(), wall_s=step_s, **tm,
             launches_forward=mk.trace_segment.launches - l0 - (
                 mk.trace_segment.winners_launches - w0),
             launches_winners=mk.trace_segment.winners_launches - w0,
             peak_mem_bytes=torch.cuda.max_memory_allocated(),
             grad_l2={k: torch.linalg.norm(g.double()).item() for k, g in grads.items()},
             card=card)
        tscene = shard.merge_params(tscene, params)
    train_wall = time.perf_counter() - t0
    train_launches = mk.trace_segment.launches
    train_winners = mk.trace_segment.winners_launches
    check(train_winners > 0, "the train path launched no winners kernel")
    check(train_launches - train_winners > 0, "the train path launched no radiance kernel")
    emit("train", scene="final_scene", width=MAIN_W, height=MAIN_H, spp=TRAIN_SPP,
         depth=MAIN_DEPTH, steps=TRAIN_STEPS, rays_per_chunk=TRAIN_CHUNK, wall_s=train_wall,
         launches=train_launches, winners_launches=train_winners,
         peak_mem_bytes=torch.cuda.max_memory_allocated(), card=card)
    emit("profile_train", **profile_fn(lambda: shard.sharded_train_step(
        tscene, tcam, target, MAIN_W, MAIN_H, TRAIN_SPP, MAIN_DEPTH, bg, 42, **train_kw),
        what="one train step"), card=card)

    emit("total", seconds=time.perf_counter() - t_start)
    # ---- kernels line: per launch, averaged over one sample batch's segments ----
    n_seg = len(segs)
    ops_ms = sum(s["ops_ms"] for s in segs)
    bytes_ms = sum(s["bytes_ms"] for s in segs)
    print(json.dumps({"kernels": [{
        "name": "megakernel",
        "route": "cuda",
        "source": "rtweekend_tpu_torch/csrc/megakernel.cu",
        "replaces": "rtweekend_tpu/ops/pallas/megakernel.py:1050",
        "launches": launches,
        "max_abs_err": max(s["max_abs"] for s in segs),
        "ms": sum(s["kernel_ms"] for s in segs) / n_seg,
        "plain_ms": sum(s["plain_ms"] for s in segs) / n_seg,
        "bound_ms": sum(s["bound_ms"] for s in segs) / n_seg,
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": None,
    }, {
        "name": "megakernel_winners",
        "route": "cuda",
        "source": "rtweekend_tpu_torch/csrc/megakernel.cu",
        "replaces": "rtweekend_tpu/ops/pallas/megakernel.py:1050",
        "launches": train_winners,
        "max_abs_err": win_res["max_abs"],
        "ms": win_ms,
        "plain_ms": win_plain_ms,
        "bound_ms": max(win_bnd["ops_ms"], win_bnd["bytes_ms"]),
        "bound_by": "operations" if win_bnd["ops_ms"] >= win_bnd["bytes_ms"] else "bytes",
        "library_ms": None,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
