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
               by kernel and the card's idle share.
Then the `kernels` line and, last, the result line. Any failed check
raises and the script exits non-zero; without a card it exits non-zero
before printing any result. Imports nothing of JAX or rtweekend_tpu.

Bars (from tests/test_pallas.py:52-69): at most 0.5% of radiance lanes
off by more than 1e-3, channel means within 2%. Discrete decisions
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
LANE_TOL, LANE_FRAC, MEAN_RTOL = 1e-3, 0.005, 0.02
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


def segment_bound(tables, state, seed, bg, b0, n_b, mk):
    """Least time (ms) the card could take for this segment's work on this
    data: the coefficient march of every live ray-bounce (17 multiply-adds
    per coefficient row, 2 FLOP each, plus the 2-FLOP discriminant per
    sphere) at the fp32 peak, or the state and tables read and written
    once at the HBM rate, whichever is larger. Live rays are counted by
    stepping the kernel one bounce at a time (not part of the main path's
    count, which is reset before the main path)."""
    rows = tables.coef.shape[0]
    flop_per_rb = 2 * 17 * rows + 2 * tables.s_pad
    live_rb = 0
    st = state
    for k in range(n_b):
        live_rb += int((st[:, mk.S_AL] > 0.5).sum().item())
        _, st = mk.trace_segment(tables, st, seed, bg, b0 + k, 1)
    m = state.shape[0]
    nbytes = (2 * m * 14 + 3 * m) * 4 + sum(
        t.numel() * t.element_size() for t in (tables.coef, tables.attr_f, tables.attr_i))
    return dict(live_ray_bounces=live_rb,
                ops_ms=live_rb * flop_per_rb / FP32_FLOPS * 1e3,
                bytes_ms=nbytes / HBM_BYTES_S * 1e3)


def profile_main(render_mod, cfg):
    """One main-path render under torch.profiler: device time by kernel,
    device busy and idle share of the host-clock wall time. Reports "not
    measured" when the profiler sees no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        render_mod.render_image(cfg)
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
        return dict(spp=cfg.samples_per_pixel, wall_ms=wall * 1e3,
                    device_busy_ms="not measured", idle_share="not measured")
    bounce_ms = sum(us for us, k in kern if "bounce_kernel" in k) / 1e3
    return dict(spp=cfg.samples_per_pixel, wall_ms=wall * 1e3, device_busy_ms=busy_ms,
                idle_share=1.0 - busy_ms / (wall * 1e3), bounce_kernel_ms=bounce_ms,
                top_kernels=[[k[:80], us / 1e3] for us, k in kern[:8]])


def main() -> int:
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
    from rtweekend_tpu_torch.ops.camera import generate_rays
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
    ptxas = [ln.strip() for ln in built.log.splitlines() if "registers" in ln or "spill" in ln]
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
    t0 = time.perf_counter()
    img, accum = render_mod.render_image(cfg)   # default device: the card
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = mk.trace_segment.launches
    check(launches > 0, "main path launched no bounce kernel")
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
    emit("profile", **profile_main(render_mod, RenderConfig(
        scene="final_scene", width=MAIN_W, height=MAIN_H, samples_per_pixel=4,
        max_depth=MAIN_DEPTH)), card=card)

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
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
