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
               simple_light and earth at 600x400 (each variant's ms/launch,
               bound, roofline share and the lanes a ray G the wrapper
               chose);
  3. compact   compacted driver bit-equal to the uncompacted kernel; an
               over-tight schedule raises the overflow flag, and the render
               driver recovers it;
  4. render    a small render through the kernel against the same render
               through the plain version (channel means); the plain render
               makes its rays with the PyTorch ops, launching no
               raygen_kernel;
  5. main      render_image of final_scene at 1200x675, depth 50, through
               the normal entry point, with the kernels' launch counts
               (raygen_kernel at least once a batch); the image goes to
               smoke_out/; then `raygen`: raygen_kernel's state for one
               1-spp batch of that render (810,000 rays) bit-equal to
               init_state of the PyTorch camera ops, the device ms of both
               and the kernel's byte bound;
  6. profile   the main path once more under torch.profiler: device time
               by kernel and the card's idle share;
  7. scenes    render_image of every scene at its own default size, depth
               50, 16 spp, through the normal entry point on the default
               device: wall seconds, primary rays/s, launches of each
               variant, a PNG in smoke_out/;
  8. winners_vs_plain  the kernel's want_winners variant against the
               plain version (final_scene, cornell_box, golden_scene,
               two_perlin_spheres; 65,536 rays, depth 8, and the train
               step's 811,008-lane pass-2 shape at depth 50) on entries
               alive on both sides, radiance bit-equal to the
               radiance-only launch, ms/launch with and without winners;
               then final_scene's full 811,008-lane batch in one
               uncompacted launch at depth 50 beside the sum of its five
               render segments;
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
               more step under torch.profiler;
 13. eager     the eager integrator (ops/integrator.py, plain tensor ops)
               against the CUDA kernel at 65,536 rays, depth 8, on the six
               scenes of phase 2; then render_image(kernel="eager") of
               final_scene at 1200x675, 1 spp, depth 50: wall, rays/s, peak
               memory, channel means against the kernel's render;
 14. f64       float64 render_image (the eager integrator) of cornell_box
               600x600 4 spp and final_scene 1200x675 1 spp, depth 50,
               against the float32 kernel render (tests/test_f64.py's bars);
 15. adaptive  every scene's adaptive compaction schedule (render_image's)
               and its CPU probe seconds; the scene's 16-spp render under
               it and under the static schedule, in turns (A S S A):
               bit-equal unless a schedule overflowed (then the recovery
               bar), the batches each schedule overflows, launches and
               mean wall of both;
 16. checkpoint  the CLI with --checkpoint in a subprocess, final_scene
               1200x675 16 spp, killed after its first save, then run again
               to the end: equal to an uninterrupted render_resumable;
 17. cli_options  the CLI with --adaptive-caps, --metrics and
               --profile-dir on the card: the events and the trace file,
               read back by utils/trace_report (`trace_report`: device time
               by kernel, category and launching op; the bounce kernel in it);
 18. train_eager  sharded_train_step(use_pallas=False) on golden_scene
               600x400, 2 spp, depth 50: seconds by pass, peak memory,
               nonzero c0, radius and albedo gradients, one more step under
               torch.profiler; then at 60x40,
               depth 8, its gradients against the kernel path's (the
               replay of the kernel's winners) on the rays whose paths
               agree, in float64 (relative L2 <= 1e-4; float32 reported);
 19. multidevice  parallel/ on the card, one JSON line a run (backend,
               world size, mesh): at world size 1 on NCCL in this process,
               render_sharded of final_scene 1200x675, 16 spp, depth 50,
               bit-equal to render under the same schedule, and one
               sharded_train_step of final_scene (4 spp) equal to the
               mesh=None step; then two ranks sharing the card over gloo
               (torch.multiprocessing.spawn): the same render at meshes
               (2, 1) and (1, 2) against render (rtol 1e-4 / atol 1e-4, the
               ranks' framebuffers bit-equal), golden_scene's train step at
               600x400, 2 spp, against the mesh=None step (loss rtol 1e-5,
               lr=1 gradients rtol 2e-3 / atol 2e-6, nonzero geometry
               gradients), and __graft_entry__.dryrun_multichip's shape
               (simple_light 16x16, 4 spp, depth 4, mesh (1, 2),
               rays_per_chunk 64: two winner blocks a rank, by the launch
               counts) in both branches, each against its mesh=None step
               and against the eager unsharded step (relative L2 < 0.05).
               These runs measure the sharded layer and the collectives on
               one card; they are not scaling.
 20. parity    tools/parity.render_baseline_configs: BASELINE configs 1-4
               (book1_diffuse 200x100 10 spp depth 10, book1_metal_dielectric
               400x225 50 spp, book1_defocus 400x225 100 spp, final_scene
               1200x675 100 spp; depth 50, seed 42) rendered on the card
               into smoke_out/parity/, each held against the JAX package's
               TPU render of it (artifacts/, named by parity_report.json):
               compare()'s statistics, the share of pixels that differ and
               that are off by more than 2 of 255 levels, the largest
               difference, the render's seconds; config 4's rows 135-270
               traced again by the plain version, its distance from the
               TPU beside the kernel's. Bars (tools/parity.py): at most
               0.5% of pixels off by > 2 levels (config 4: 1.2%, 1.3x what
               JAX's own CPU render shows against its TPU render), channel
               means within 0.002, every 3x3 region within 0.005; on config
               4's band the kernel against the plain version at most 0.8%
               of pixels off by > 2 levels (1.3x the 0.608% measured) and
               channel means within 0.002; the committed artifacts and
               parity_report.json unchanged;
 21. tools     tools/bench_scenes.main([]) (five rows, rays/s and launches
               positive), tools/bench.main([]) (the headline line, then the
               roofline with 0 < pct_of_sol <= 100 and a finite
               fwd_bwd_rays_per_s) and tools/bench_scaling.main on two gloo
               ranks sharing the card (rows k = 1, 2, positive rays/s, a
               collective share of busy time in [0, 1]), their output
               echoed.
 22. native    the host image runtime (utils/native.py): the compiler,
               its build seconds and zlib's version; the four TPU artifacts'
               pixels re-encoded byte-equal to the committed files (where
               zlib is another release than ARTIFACT_ZLIB, a PNG's inflated
               IDAT stream equal instead); phase 5's image through
               write_png / write_ppm byte-equal to the plain encoders and
               read back equal; host ms of each native encoder (median of
               5) and of its plain version (the one call that checks it)
               at 1200x675.
Every scene's schedule (its CPU probe) is computed after phase 1, before
any timed render: host set-up cached per scene, like the kernel build.
Kernel times are device time only: the launches are enqueued behind a
device-side spin that outlasts the enqueueing (utils/timing.device_ms),
and the host's time per call is reported beside them. The plain version
synchronises inside, so its time is by events around the calls.
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
import shutil
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
CKPT_SPP = 16            # the checkpointed render: 16 batches, a save every 4
TRAIN_EAGER_SPP = 2
ARTIFACT_ZLIB = "1.2.13"  # a zlib release whose deflate reproduces artifacts/'s PNGs
# phase 19: two ranks sharing the card over gloo; golden_scene's step at
# 2 spp; the shape of __graft_entry__.dryrun_multichip (simple_light 16x16,
# 4 spp, depth 4, mesh (1, 2), rays_per_chunk 64: two winner blocks a rank)
MD_WORLD, MD_MESHES, MD_GOLDEN_SPP = 2, ((2, 1), (1, 2)), 2
DRYRUN_SIDE, DRYRUN_SPP, DRYRUN_DEPTH, DRYRUN_CHUNK = 16, 4, 4, 64
MD_GRAD_RTOL, MD_GRAD_ATOL = 2e-3, 2e-6
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


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def gpu_ms(fn, reps):
    """(device ms, host ms) per call of fn() over reps calls (after one
    warm-up call): the launches are enqueued behind a device-side spin that
    outlasts the enqueueing, so the CUDA events bracket device time only
    (utils/timing.device_ms); the host ms is the enqueueing loop's."""
    from rtweekend_tpu_torch.utils.timing import device_ms

    return device_ms(fn, reps)


def synced_ms(fn, reps):
    """Mean milliseconds of fn() over reps runs, by CUDA events around the
    calls (after one warm-up run): for work that synchronises with the
    host inside (the plain version's masked gathers, the replay), where
    the device waits for the host anyway."""
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


def segment_bound(tables, scene, state, seed, bg, b0, n_b, mk):
    """Least time (ms) the card could take for this segment's work on this
    data, over the scene's real primitives (the padding of the packed
    tables left out): the coefficient march of every live ray-bounce (17
    multiply-adds per coefficient row, 2 FLOP each, over the 2S+6R real
    rows, plus the 2-FLOP discriminant per real sphere), the noise and
    image texture work of every live hit on such a texture and the
    gradient sky of every live miss, at the fp32 peak; or the state read
    and written once, the real rows of the tables read once (17 features
    per coefficient row, 34 attributes per primitive, the 6 KB Perlin
    tables and the texel atlas where the variant reads them) and the
    radiance written once, at the HBM rate; whichever is larger.
    Live rays and their hits are counted by stepping the kernel's winners
    variant one bounce at a time (not part of the main path's counts,
    which are reset before each main path)."""
    import numpy as np

    from rtweekend_tpu_torch.utils.roofline import (
        COEF_FEATURES, FP32_FLOPS, HBM_BYTES_S, IMAGE_OPS, NOISE_OPS, SKY_OPS, coef_rows,
        march_flop)

    ns = int(scene.spheres.active.sum().item())
    nr = int(scene.rects.active.sum().item())
    rows = coef_rows(ns, nr)
    flop_per_rb = march_flop(ns, nr)
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
    table_bytes = (rows * COEF_FEATURES + (29 + 5) * (ns + nr)) * 4
    table_bytes += 2 * 768 * 4 if tables.has_noise else 0
    texels = int((scene.image_w.long() * scene.image_h.long()).sum().item())
    table_bytes += texels * 4 if tables.has_image else 0
    nbytes = (2 * m * 14 + 3 * m) * 4 + table_bytes
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
    """fn() once under torch.profiler (utils/profiling.device_profile)."""
    from rtweekend_tpu_torch.utils.profiling import device_profile

    return device_profile(fn, **meta)


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def sha(tensors):
    """sha256 of the bytes of a tensor or of a dict of tensors."""
    import hashlib

    h = hashlib.sha256()
    for t in (tensors.values() if isinstance(tensors, dict) else [tensors]):
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def grads_of(p0, p1):
    """lr = 1: the gradient is p0 - p1."""
    return {k: (p0[k] - p1[k]).double() for k in p0}


def hold_step(what, p0, got, want, want_loss):
    """A sharded step against the mesh=None step: loss rtol 1e-5 and lr=1
    gradients rtol 2e-3 / atol 2e-6 (tests/test_sharding.py:59-100).
    got = (params, loss) on the CPU. Returns the gradients' max abs diff."""
    import torch

    params, loss = got
    check(abs(loss - want_loss) <= 1e-5 * abs(want_loss),
          f"{what}: loss {loss} vs mesh=None {want_loss}")
    g, w = grads_of(p0, params), grads_of(p0, want)
    for k in g:
        check(bool(torch.isfinite(g[k]).all()), f"{what}: grad {k} not finite")
        check(torch.allclose(g[k], w[k], rtol=MD_GRAD_RTOL, atol=MD_GRAD_ATOL),
              f"{what}: grad {k} max diff {(g[k] - w[k]).abs().max().item()}")
    return max((g[k] - w[k]).abs().max().item() for k in g)


def multidevice_rank(rank, world, port, inputs_path, out_dir):
    """One of the ranks sharing the card over gloo (phase 19), started by
    torch.multiprocessing.spawn: the collective alone at the framebuffer's
    shape, the dry-run shape in both branches, final_scene's render at each
    mesh of MD_MESHES (twice: cold, warm) and golden_scene's train step at
    each. Writes its results to <out_dir>/md_rank<rank>.pt;
    rank 0 adds the framebuffers and parameters."""
    import torch
    import torch.distributed as dist

    from rtweekend_tpu_torch import render as render_mod
    from rtweekend_tpu_torch.config import SCENE_DEFAULTS
    from rtweekend_tpu_torch.models.builders import build_scene
    from rtweekend_tpu_torch.ops.cuda import megakernel as mk
    from rtweekend_tpu_torch.parallel import multihost, shard
    from rtweekend_tpu_torch.parallel.mesh import make_mesh

    dev = multihost.initialize(f"127.0.0.1:{port}", world, rank, backend="gloo")
    inp = torch.load(inputs_path)
    out = dict(rank=rank, device=str(dev), backend=dist.get_backend(), world=world)

    buf = torch.zeros((MAIN_W * MAIN_H, 3), device=dev)
    dist.all_reduce(buf)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        dist.all_reduce(buf)
    torch.cuda.synchronize()
    out["allreduce_ms"] = (time.perf_counter() - t0) / 5 * 1e3
    del buf

    # the dry-run shape first: its tiny step loads the replay's and the
    # backward's device code, which the timed golden_scene steps then find
    sscene = build_scene("simple_light", device=dev)
    scam = render_mod.camera_for_scene("simple_light", 1.0, dev)
    mesh = make_mesh((world // 2, 2))
    for branch, kw in (("kernel", {}), ("eager", dict(use_pallas=False))):
        mk.reset_launch_counts()
        params, loss = shard.sharded_train_step(
            sscene, scam, inp["dryrun_target"].to(dev), DRYRUN_SIDE, DRYRUN_SIDE, DRYRUN_SPP,
            DRYRUN_DEPTH, (0.0, 0.0, 0.0), 43, mesh, lr=1.0, rays_per_chunk=DRYRUN_CHUNK, **kw)
        out[f"dryrun_{branch}"] = dict(counts=mk.launch_counts(), loss=loss.item(),
                                       sha=sha(params))
        if rank == 0:
            out[f"dryrun_params_{branch}"] = {k: v.cpu() for k, v in params.items()}
    scene = build_scene("final_scene", device=dev)
    cam = render_mod.camera_for_scene("final_scene", MAIN_W / MAIN_H, dev)
    bg = SCENE_DEFAULTS["final_scene"]["background"]
    for shape in MD_MESHES:
        mesh = make_mesh(shape)
        tag = f"{shape[0]}x{shape[1]}"
        walls, fbs = [], []
        for _ in range(2):
            dist.barrier()
            torch.cuda.synchronize()
            mk.reset_launch_counts()
            t0 = time.perf_counter()
            fbs.append(shard.render_sharded(scene, cam, MAIN_W, MAIN_H, MAIN_SPP, MAIN_DEPTH,
                                            bg, 42, mesh, capacities=inp["caps"]))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        out[f"render_{tag}"] = dict(coord=list(mesh.get_coordinate()), wall_s=walls,
                                    launches=mk.launch_counts()["launches"], sha=sha(fbs[0]),
                                    repeat_equal=bool(torch.equal(fbs[0], fbs[1])))
        if rank == 0:
            out[f"fb_{tag}"] = fbs[0].cpu()
        del fbs

    gp = SCENE_DEFAULTS["golden_scene"]
    gscene = shard.merge_params(build_scene("golden_scene", device=dev),
                                {k: v.to(dev) for k, v in inp["golden_p0"].items()})
    gcam = render_mod.camera_for_scene("golden_scene", gp["width"] / gp["height"], dev)
    for shape in MD_MESHES:
        mesh = make_mesh(shape)
        tag = f"{shape[0]}x{shape[1]}"
        dist.barrier()
        torch.cuda.synchronize()
        mk.reset_launch_counts()
        tm = {}
        t0 = time.perf_counter()
        params, loss = shard.sharded_train_step(
            gscene, gcam, inp["golden_target"].to(dev), gp["width"], gp["height"],
            MD_GOLDEN_SPP, MAIN_DEPTH, gp["background"], 42, mesh, lr=1.0, timings=tm)
        torch.cuda.synchronize()
        out[f"golden_{tag}"] = dict(wall_s=time.perf_counter() - t0, timings=tm,
                                    counts=mk.launch_counts(), loss=loss.item(), sha=sha(params))
        if rank == 0:
            out[f"golden_params_{tag}"] = {k: v.cpu() for k, v in params.items()}

    torch.save(out, os.path.join(out_dir, f"md_rank{rank}.pt"))
    dist.destroy_process_group()


def multidevice_phase(dev, card, main_caps):
    """Phase 19: render_sharded and sharded_train_step(mesh=) on the card,
    first at world size 1 on NCCL in this process, then on two ranks that
    share the card over gloo (multidevice_rank), each held against the
    single-device result. Returns the phase's seconds."""
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from rtweekend_tpu_torch import render as render_mod
    from rtweekend_tpu_torch.config import SCENE_DEFAULTS
    from rtweekend_tpu_torch.models.builders import build_scene
    from rtweekend_tpu_torch.ops.cuda import megakernel as mk
    from rtweekend_tpu_torch.parallel import multihost, shard
    from rtweekend_tpu_torch.parallel.mesh import make_mesh

    t_phase = time.perf_counter()
    scene = build_scene("final_scene", device=dev)
    cam = render_mod.camera_for_scene("final_scene", MAIN_W / MAIN_H, dev)
    bg = SCENE_DEFAULTS["final_scene"]["background"]

    def synced(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # ---- world size 1 on NCCL, in this process ----
    multihost.initialize(f"127.0.0.1:{free_port()}", 1, 0)
    check(dist.get_backend() == "nccl", f"backend {dist.get_backend()}")
    mesh = make_mesh((1, 1))
    ref, ref_s = synced(lambda: render_mod.render(scene, cam, MAIN_W, MAIN_H, MAIN_SPP,
                                                  MAIN_DEPTH, bg, 42, capacities=main_caps))
    fbs, fb_s = [], []   # cold (the first NCCL collective sets up its communicator), warm
    for _ in range(2):
        mk.reset_launch_counts()
        fb, wall = synced(lambda: shard.render_sharded(scene, cam, MAIN_W, MAIN_H, MAIN_SPP,
                                                       MAIN_DEPTH, bg, 42, mesh,
                                                       capacities=main_caps))
        fbs.append(fb)
        fb_s.append(wall)
    launches = mk.launch_counts()["launches"]
    check(launches > 0, "render_sharded launched no bounce kernel")
    check(all(torch.equal(fb, ref) for fb in fbs),
          "NCCL world-1 render_sharded is not bit-equal to render")
    ref2, ref2_s = synced(lambda: render_mod.render(scene, cam, MAIN_W, MAIN_H, MAIN_SPP,
                                                    MAIN_DEPTH, bg, 42, capacities=main_caps))
    emit("multidevice", run="render", backend="nccl", world_size=1, mesh=[1, 1],
         scene="final_scene", width=MAIN_W, height=MAIN_H, spp=MAIN_SPP, depth=MAIN_DEPTH,
         bit_equal=True, wall_s_render=[ref_s, ref2_s], wall_s_render_sharded=fb_s,
         launches=launches, card=card)
    del fb
    target = shard.kernel_mean_image(scene, cam, MAIN_W, MAIN_H, TRAIN_SPP, MAIN_DEPTH, bg, 42)
    p0 = shard.extract_params(scene)
    tscene = shard.merge_params(scene, dict(p0, color=p0["color"] * 0.8))
    steps = {"none": [], "mesh": []}
    for name in ("none", "mesh", "mesh", "none"):   # in turns
        tm = {}
        mk.reset_launch_counts()
        (params, loss), wall = synced(lambda: shard.sharded_train_step(
            tscene, cam, target, MAIN_W, MAIN_H, TRAIN_SPP, MAIN_DEPTH, bg, 42,
            mesh if name == "mesh" else None, lr=1.0, timings=tm))
        steps[name].append((params, loss, wall, tm, mk.launch_counts()))
    pn, ln = steps["none"][0][:2]
    for params, loss, *_ in steps["none"] + steps["mesh"]:
        diff = max((pn[k] - params[k]).abs().max().item() for k in pn)
        check(torch.equal(ln, loss) and diff == 0.0,
              f"NCCL world-1 train step: loss {loss.item()} vs {ln.item()}, "
              f"params max diff {diff}")
    emit("multidevice", run="train", backend="nccl", world_size=1, mesh=[1, 1],
         scene="final_scene", width=MAIN_W, height=MAIN_H, spp=TRAIN_SPP, depth=MAIN_DEPTH,
         loss=ln.item(), params_max_abs_diff=0.0,
         wall_s=[st[2] for st in steps["mesh"]], wall_s_mesh_none=[st[2] for st in steps["none"]],
         timings=[st[3] for st in steps["mesh"]],
         timings_mesh_none=[st[3] for st in steps["none"]], **steps["mesh"][0][4], card=card)
    dist.destroy_process_group()
    del steps, pn, fbs, ref2, target, tscene
    torch.cuda.empty_cache()

    # ---- references of the two-rank runs, on one device ----
    gp = SCENE_DEFAULTS["golden_scene"]
    gscene = build_scene("golden_scene", device=dev)
    gcam = render_mod.camera_for_scene("golden_scene", gp["width"] / gp["height"], dev)
    gtarget = shard.kernel_mean_image(gscene, gcam, gp["width"], gp["height"], MD_GOLDEN_SPP,
                                      MAIN_DEPTH, gp["background"], 42)
    g0 = shard.extract_params(gscene)
    gp0 = dict(g0, color=g0["color"] * 0.8)
    gscene = shard.merge_params(gscene, gp0)
    (gp1, gloss), gwall = synced(lambda: shard.sharded_train_step(
        gscene, gcam, gtarget, gp["width"], gp["height"], MD_GOLDEN_SPP, MAIN_DEPTH,
        gp["background"], 42, lr=1.0))
    sscene = build_scene("simple_light", device=dev)
    scam = render_mod.camera_for_scene("simple_light", 1.0, dev)
    dtarget = render_mod.render(sscene, scam, DRYRUN_SIDE, DRYRUN_SIDE, DRYRUN_SPP,
                                DRYRUN_DEPTH, (0.0, 0.0, 0.0), 42) / DRYRUN_SPP
    dry = {branch: shard.sharded_train_step(
        sscene, scam, dtarget, DRYRUN_SIDE, DRYRUN_SIDE, DRYRUN_SPP, DRYRUN_DEPTH,
        (0.0, 0.0, 0.0), 43, lr=1.0, rays_per_chunk=DRYRUN_CHUNK, **kw)
        for branch, kw in (("kernel", {}), ("eager", dict(use_pallas=False)))}
    inputs = os.path.join(OUT_DIR, "md_inputs.pt")
    torch.save(dict(caps=main_caps, golden_p0={k: v.cpu() for k, v in gp0.items()},
                    golden_target=gtarget.cpu(), dryrun_target=dtarget.cpu()), inputs)
    for r in range(MD_WORLD):
        path = os.path.join(OUT_DIR, f"md_rank{r}.pt")
        if os.path.exists(path):
            os.unlink(path)
    torch.cuda.empty_cache()

    # ---- two ranks sharing the card over gloo (the kernel is built: the
    # ranks load the library this process built) ----
    t0 = time.perf_counter()
    mp.spawn(multidevice_rank, args=(MD_WORLD, free_port(), inputs, OUT_DIR), nprocs=MD_WORLD,
             join=True)
    spawn_s = time.perf_counter() - t0
    res = [torch.load(os.path.join(OUT_DIR, f"md_rank{r}.pt")) for r in range(MD_WORLD)]
    for r, rr in enumerate(res):
        check(rr["backend"] == "gloo" and torch.device(rr["device"]).type == dev.type
              and rr["rank"] == r, f"rank {r}: {rr['backend']} on {rr['device']}")
    for shape in MD_MESHES:
        tag = f"{shape[0]}x{shape[1]}"
        got = res[0][f"fb_{tag}"].to(dev)
        check(all(rr[f"render_{tag}"]["sha"] == res[0][f"render_{tag}"]["sha"] for rr in res),
              f"gloo {tag}: the ranks' framebuffers differ")
        check(all(rr[f"render_{tag}"]["repeat_equal"] for rr in res),
              f"gloo {tag}: a repeated render differs")
        check(all(rr[f"render_{tag}"]["launches"] > 0 for rr in res),
              f"gloo {tag}: a rank launched no bounce kernel")
        check(torch.allclose(got, ref, rtol=1e-4, atol=1e-4),
              f"gloo {tag}: render_sharded vs render max diff {(got - ref).abs().max().item()}")
        emit("multidevice", run="render", backend="gloo", world_size=MD_WORLD, mesh=list(shape),
             scene="final_scene", width=MAIN_W, height=MAIN_H, spp=MAIN_SPP, depth=MAIN_DEPTH,
             bit_equal=bool(torch.equal(got, ref)), max_abs_diff=(got - ref).abs().max().item(),
             wall_s_render=ref_s, ranks=[rr[f"render_{tag}"] for rr in res],
             allreduce_ms=[rr["allreduce_ms"] for rr in res],
             allreduce_bytes=MAIN_W * MAIN_H * 3 * 4, card=card)
    gp0_cpu = {k: v.cpu() for k, v in gp0.items()}
    gp1_cpu = {k: v.cpu() for k, v in gp1.items()}
    for shape in MD_MESHES:
        tag = f"{shape[0]}x{shape[1]}"
        got = res[0][f"golden_params_{tag}"]
        check(all(rr[f"golden_{tag}"]["sha"] == res[0][f"golden_{tag}"]["sha"]
                  and rr[f"golden_{tag}"]["loss"] == res[0][f"golden_{tag}"]["loss"]
                  for rr in res), f"gloo golden {tag}: the ranks' parameters differ")
        dmax = hold_step(f"gloo golden {tag}", gp0_cpu, (got, res[0][f"golden_{tag}"]["loss"]),
                         gp1_cpu, gloss.item())
        g = grads_of(gp0_cpu, got)
        for k in ("c0", "radius", "color"):
            check(g[k].abs().sum().item() > 0, f"gloo golden {tag}: zero {k} gradient")
        emit("multidevice", run="train", backend="gloo", world_size=MD_WORLD, mesh=list(shape),
             scene="golden_scene", width=gp["width"], height=gp["height"], spp=MD_GOLDEN_SPP,
             depth=MAIN_DEPTH, loss=res[0][f"golden_{tag}"]["loss"], loss_mesh_none=gloss.item(),
             grad_max_abs_diff=dmax, wall_s_mesh_none=gwall,
             ranks=[rr[f"golden_{tag}"] for rr in res],
             grad_l2={k: torch.linalg.norm(v).item() for k, v in g.items()}, card=card)
    s0 = {k: v.cpu() for k, v in shard.extract_params(sscene).items()}
    eager_ref = grads_of(s0, {k: v.cpu() for k, v in dry["eager"][0].items()})
    for branch in ("kernel", "eager"):
        got = res[0][f"dryrun_params_{branch}"]
        check(all(rr[f"dryrun_{branch}"]["sha"] == res[0][f"dryrun_{branch}"]["sha"]
                  for rr in res), f"dry run {branch}: the ranks' parameters differ")
        blocks = [rr[f"dryrun_{branch}"]["counts"]["winners_launches"] for rr in res]
        check(blocks == ([2] * MD_WORLD if branch == "kernel" else [0] * MD_WORLD),
              f"dry run {branch}: winner blocks a rank {blocks}")
        want = {k: v.cpu() for k, v in dry[branch][0].items()}
        dmax = hold_step(f"dry run {branch}", s0, (got, res[0][f"dryrun_{branch}"]["loss"]),
                         want, dry[branch][1].item())
        # __graft_entry__.py:110-120: against the eager unsharded estimator
        g = grads_of(s0, got)
        rel = {k: rel_l2(g[k], eager_ref[k]) for k in g}
        for k in g:
            den = torch.linalg.norm(eager_ref[k]).item()
            check(rel[k] < 0.05 or den < 1e-8, f"dry run {branch}: grad {k} relative L2 "
                  f"{rel[k]} against the eager unsharded step")
        emit("multidevice", run="dryrun", backend="gloo", world_size=MD_WORLD,
             mesh=[MD_WORLD // 2, 2], branch=branch, scene="simple_light", width=DRYRUN_SIDE,
             height=DRYRUN_SIDE, spp=DRYRUN_SPP, depth=DRYRUN_DEPTH,
             rays_per_chunk=DRYRUN_CHUNK, winner_blocks=blocks,
             loss=res[0][f"dryrun_{branch}"]["loss"], loss_mesh_none=dry[branch][1].item(),
             grad_max_abs_diff=dmax, rel_l2_vs_eager_unsharded=rel, card=card)
    seconds = time.perf_counter() - t_phase
    emit("multidevice_phase", seconds=seconds, spawn_s=spawn_s, card=card)
    return seconds


def parity_phase(dev, card):
    """Phase 20: tools/parity.render_baseline_configs on the card, each
    config's image held against the JAX package's TPU render of it
    (parity_report.json, artifacts/): compare()'s statistics, the pixel
    statistics and the render's seconds, one line a config; config 4's
    band (parity.PLAIN_BAND) traced again by the plain version; then the
    bars, the kernel against the plain version on the band, and the
    committed artifacts and report unchanged. Returns the phase's
    seconds."""
    from rtweekend_tpu_torch.tools import parity

    t_phase = time.perf_counter()
    report_sha = parity._sha256(parity.TPU_REPORT)
    rows = parity.render_baseline_configs(os.path.join(OUT_DIR, "parity"), device=dev)
    vs = parity.against_tpu(rows)
    for key, row in rows.items():
        emit("parity", config=key, **{k: row[k] for k in (
            "scene", "width", "height", "spp", "max_depth", "render_s", "sha256", "finite")},
             **vs[key], card=card)
    # config 4's rows 135-270 (where the pixels that differ are densest)
    # through the plain version on the card: how far the exact-order fp32
    # formula is from the TPU render, beside the kernel's distance, and the
    # kernel held to it
    t0 = time.perf_counter()
    band_key, top, bottom = parity.PLAIN_BAND
    band = parity.band_against_plain(band_key, rows[band_key], top, bottom, device=dev)
    emit("parity_plain_band", config=band_key, **band, seconds=time.perf_counter() - t0,
         bar=dict(pixels_off_by_gt2_frac=parity.PLAIN_OFF2_FRAC, channel_mean=parity.MEAN_TOL),
         card=card)
    unchanged = parity.tpu_artifacts_unchanged()
    seconds = time.perf_counter() - t_phase
    emit("parity_phase", seconds=seconds, artifacts_unchanged=unchanged,
         bars=dict(pixels_off_by_gt2_frac=parity.OFF2_FRAC, channel_mean=parity.MEAN_TOL,
                   region=parity.REGION_TOL), card=card)
    check(all(unchanged.values()) and parity._sha256(parity.TPU_REPORT) == report_sha,
          f"a committed TPU artifact or parity_report.json changed: {unchanged}")
    for key, row in rows.items():
        v = vs[key]
        check(row["finite"], f"parity {key}: non-finite radiance")
        check(v["pixels_off_by_gt2_frac"] <= parity.OFF2_FRAC[key],
              f"parity {key}: {v['pixels_off_by_gt2_frac']} of pixels off by > 2 levels")
        check(v["channel_mean_max_abs_diff"] <= parity.MEAN_TOL,
              f"parity {key}: channel means {v['channel_means_ours']} vs TPU "
              f"{v['channel_means_golden']}")
        check(max(v["region_mean_abs_diff"].values()) <= parity.REGION_TOL,
              f"parity {key}: regions {v['region_mean_abs_diff']}")
    vp = band["image_vs_plain"]
    check(vp["pixels_off_by_gt2_frac"] <= parity.PLAIN_OFF2_FRAC
          and vp["channel_mean_max_abs_diff"] <= parity.MEAN_TOL,
          f"parity {band_key} rows {top}-{bottom}: kernel against plain {vp}")
    return seconds


def tool_run(fn, argv):
    """fn(argv) with its standard output captured, echoed and returned as
    (lines, JSON objects among them, seconds); fails unless it returns 0."""
    import contextlib
    import io
    import math

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = fn(argv)
    seconds = time.perf_counter() - t0
    print(buf.getvalue(), end="", flush=True)
    check(rc == 0, f"{fn.__module__}.main({argv}) returned {rc}")
    lines = buf.getvalue().splitlines()
    objs = [json.loads(ln) for ln in lines if ln.startswith("{")]
    for o in objs:
        for k, v in o.items():
            check(not isinstance(v, float) or math.isfinite(v), f"{fn.__module__}: {k} = {v}")
    return lines, objs, seconds


def tools_phase(card):
    """Phase 21: tools/bench_scenes, tools/bench and tools/bench_scaling (two
    gloo ranks sharing the card) at their defaults, their JSON lines
    checked. Returns the phase's seconds."""
    from rtweekend_tpu_torch.tools import bench, bench_scaling, bench_scenes

    t_phase = time.perf_counter()
    lines, rows, scenes_s = tool_run(bench_scenes.main, [])
    check(lines[0] == card, f"bench_scenes: first line {lines[0]!r}, not the card's")
    check([r["scene"] for r in rows] == [c[0] for c in bench_scenes.CONFIGS],
          f"bench_scenes: rows {[r['scene'] for r in rows]}")
    for r in rows:
        check(r["rays_per_s"] > 0 and r["launches"] > 0, f"bench_scenes: {r}")

    _, objs, bench_s = tool_run(bench.main, [])
    check(len(objs) == 2, f"bench: {len(objs)} JSON lines")
    head, full = objs
    check(set(head) == {"metric", "value", "unit", "warm_s", "exec_s", "card"}
          and head["metric"] == f"rays_per_s_card_{bench.SCENE}_{bench.WIDTH}x{bench.HEIGHT}"
          and head["value"] > 0 and full["card"] == card,
          f"bench: headline {head}")
    check(0 < full["pct_of_sol"] <= 100, f"bench: pct_of_sol {full['pct_of_sol']}")
    check(full["fwd_bwd_rays_per_s"] > 0, f"bench: fwd_bwd {full['fwd_bwd_rays_per_s']}")

    _, objs, scaling_s = tool_run(bench_scaling.main, [
        "--backend", "cuda", "--ranks-per-card", "2", "--max-ranks", "2"])
    srows = [o for o in objs if "devices" in o]
    check([r["devices"] for r in srows] == [1, 2], f"bench_scaling: rows {srows}")
    for r in srows:
        check(r["rays_per_s"] > 0 and 0 <= r["collective_frac_of_busy"] <= 1,
              f"bench_scaling: {r}")
    seconds = time.perf_counter() - t_phase
    emit("tools_phase", seconds=seconds, bench_scenes_s=scenes_s, bench_s=bench_s,
         bench_scaling_s=scaling_s, card=card)
    return seconds


def native_phase(card, img, reps=5):
    """Phase 22: the host image runtime (utils/native.py) against the
    committed TPU artifacts and its plain versions, on phase 5's image
    `img` (uint8 on the host). Returns the phase's seconds."""
    import statistics
    import zlib

    import numpy as np

    from rtweekend_tpu_torch.tools import parity
    from rtweekend_tpu_torch.utils import image as image_mod
    from rtweekend_tpu_torch.utils import native

    t_phase = time.perf_counter()
    _, built = native.load()
    cxx = subprocess.run([built.compiler, "--version"], capture_output=True, text=True)
    zlib_version = zlib.ZLIB_RUNTIME_VERSION
    emit("native_build", compiler=built.compiler, compiler_version=cxx.stdout.split("\n")[0],
         lib=os.path.relpath(built.path), build_s=built.seconds, zlib=zlib_version, card=card)

    def idat_stream(data):
        return zlib.decompress(b"".join(c for tag, c in image_mod._png_chunks(data)
                                        if tag == b"IDAT"))

    for key, row in parity.tpu_rows().items():
        path = row["artifact"]
        pixels = image_mod.read_rgb(path)
        with open(path, "rb") as f:
            want = f.read()
        is_ppm = path.endswith(".ppm")
        got = native.ppm_encode(pixels) if is_ppm else native.png_encode(pixels)
        match = "bytes" if got == want else None
        if match is None and not is_ppm and zlib_version != ARTIFACT_ZLIB:
            # deflate's output is stable only within a zlib release
            match = "inflated" if idat_stream(got) == idat_stream(want) else None
        emit("native_artifact", config=key, artifact=os.path.relpath(path),
             shape=list(pixels.shape), bytes=len(want), encoded_bytes=len(got), match=match,
             zlib=zlib_version, card=card)
        check(match is not None, f"native: {path} re-encoded to {len(got)} bytes, not its "
                                 f"own {len(want)} (zlib {zlib_version})")

    # phase 5's image through the writers, against the plain encoders,
    # each plain encoder timed in the one call that checks it
    stem = os.path.join(OUT_DIR, "chip_smoke_final_scene_native")
    image_mod.write_png(stem + ".png", img)
    image_mod.write_ppm(stem + ".ppm", img)
    with open(stem + ".png", "rb") as f:
        png = f.read()
    with open(stem + ".ppm", "rb") as f:
        ppm = f.read()

    def timed_ms(fn):
        t0 = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t0) * 1e3

    png_plain, png_plain_ms = timed_ms(lambda: native.png_encode_plain(img))
    ppm_plain, ppm_plain_ms = timed_ms(lambda: native.ppm_encode_plain(img))
    check(png == png_plain, "native: write_png differs from the plain encoder")
    check(ppm == ppm_plain, "native: write_ppm differs from the plain encoder")
    check(np.array_equal(image_mod.read_png(stem + ".png"), img)
          and np.array_equal(image_mod.read_ppm(stem + ".ppm"), img),
          "native: the written image does not read back equal")

    # host ms of each native encoder, in turns
    fns = {"png": lambda: native.png_encode(img), "ppm": lambda: native.ppm_encode(img)}
    ms = {k: [] for k in fns}
    for r in range(reps):
        for k, fn in (fns.items() if r % 2 == 0 else reversed(fns.items())):
            ms[k].append(timed_ms(fn)[1])
    h, w, _ = img.shape
    seconds = time.perf_counter() - t_phase
    emit("native", width=w, height=h, png_bytes=len(png), ppm_bytes=len(ppm), reps=reps,
         **{f"{k}_ms": statistics.median(v) for k, v in ms.items()},
         **{f"{k}_ms_range": [min(v), max(v)] for k, v in ms.items()},
         png_plain_ms=png_plain_ms, ppm_plain_ms=ppm_plain_ms, seconds=seconds, card=card)
    return seconds


def main() -> int:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 2
    import rtweekend_tpu_torch  # noqa: F401  (sets fp32 matmul policy)
    from rtweekend_tpu_torch.config import SCENE_DEFAULTS, RenderConfig
    from rtweekend_tpu_torch.device import describe
    from rtweekend_tpu_torch.models import builders
    from rtweekend_tpu_torch.models.builders import build_scene
    from rtweekend_tpu_torch.ops.cuda import build
    from rtweekend_tpu_torch.ops.cuda import megakernel as mk
    from rtweekend_tpu_torch import render as render_mod
    from rtweekend_tpu_torch.grad import make_loss
    from rtweekend_tpu_torch.ops.camera import batch_rays, generate_rays
    from rtweekend_tpu_torch.ops.cuda import vjp
    from rtweekend_tpu_torch.ops.replay import trace_paths_replay_fast
    from rtweekend_tpu_torch.parallel import shard
    from rtweekend_tpu_torch.utils import image as image_mod
    from rtweekend_tpu_torch.utils import trace_report
    from rtweekend_tpu_torch.utils.roofline import HBM_BYTES_S
    from rtweekend_tpu_torch import checkpoint, cli
    from rtweekend_tpu_torch.ops import integrator
    from rtweekend_tpu_torch.tools import bench, bench_scaling, bench_scenes, parity  # noqa: F401

    for mod in list(sys.modules):
        check(not (mod == "jax" or mod.startswith("jax.") or mod == "rtweekend_tpu"
                   or mod.startswith("rtweekend_tpu.")), f"imported {mod}")
    os.makedirs(OUT_DIR, exist_ok=True)
    dev = torch.device(DEVICE)
    kind = torch.cuda.get_device_name(0)
    smi = card = describe(dev)

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

    # every scene's compaction schedule (render_image's): its CPU probe is
    # host set-up, cached per scene as the kernel build is, so it runs here,
    # outside every timed render, and its seconds go into the adaptive phase
    probe_s = {}
    for name, p in SCENE_DEFAULTS.items():
        t0 = time.perf_counter()
        render_mod.adaptive_capacities(name, p["background"], MAIN_DEPTH)
        probe_s[name] = time.perf_counter() - t0

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
        k_ms, k_host_ms = gpu_ms(lambda: mk.trace_paths(*args, kernel="cuda"), 5)
        emit("kernel_vs_plain", scene=name, rays=CMP_SIDE ** 2, depth=depth, **res,
             kernel_ms=k_ms, kernel_host_ms=k_host_ms,
             group=mk.trace_segment.last_shape[0], blocks=mk.trace_segment.last_shape[1],
             plain_ms=synced_ms(lambda: mk.trace_paths(*args, kernel="torch"), 2),
             **bnd, bound_ms=max(bnd["ops_ms"], bnd["bytes_ms"]), card=card)

    def main_segments(name, width, height):
        """Every segment of one sample batch (1 spp) of the scene's render
        at width x height, kernel against plain at its own shape."""
        scene = build_scene(name, device=dev)
        tables = mk.pack_scene(scene)
        bg = SCENE_DEFAULTS[name]["background"]
        cam = render_mod.camera_for_scene(name, width / height, dev)
        o, d, t, pid, sid = batch_rays(cam, 42, 0, width=width, height=height, n_samples=1)
        n = o.shape[0]
        state = mk.init_state(o, d, t, pid, sid)
        count = torch.tensor(n, device=dev)
        segs = []
        caps = render_mod.adaptive_capacities(name, bg, MAIN_DEPTH)   # render_image's
        for b0, n_b, out_cap in mk.schedule(n, MAIN_DEPTH, caps):
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
            k_ms, k_host_ms = gpu_ms(
                lambda: mk.trace_segment(tables, state, 42, bg, b0, n_b), 10)
            group, blocks = mk.trace_segment.last_shape
            p_ms = synced_ms(lambda: mk.trace_segment_plain(tables, state, 42, bg, b0, n_b), 1)
            bnd = segment_bound(tables, scene, state, 42, bg, b0, n_b, mk)
            bound_ms = max(bnd["ops_ms"], bnd["bytes_ms"])
            seg = dict(b0=b0, bounces=n_b, cap=out_cap, **bnd, kernel_ms=k_ms,
                       kernel_host_ms=k_host_ms, plain_ms=p_ms, bound_ms=bound_ms,
                       roofline_share=bound_ms / k_ms, group=group, blocks=blocks,
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
    comp, ovf = mk.trace_paths_compact(tables, mk.init_state(o, d, t, pid, sid), len(pid),
                                       42, bg, 9, capacities=((1, 0.9), (3, 0.5), (6, 0.3)),
                                       kernel="cuda")
    check(not ovf.item(), "compaction overflowed on a roomy schedule")
    check(torch.equal(comp, full), "compacted != uncompacted")
    cb = build_scene("cornell_box", device=dev)
    ctab = mk.pack_scene(cb)
    ccam = render_mod.camera_for_scene("cornell_box", 1.0, dev)
    o, d, t, pid, sid = rays("cornell_box", 32, 1.0, 4096)
    _, ovf = mk.trace_paths_compact(ctab, mk.init_state(o, d, t, pid, sid), len(pid), 42,
                                    (0.0, 0.0, 0.0), 6, capacities=((2, 0.1),), kernel="cuda")
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
    mk.reset_launch_counts()
    img_k, acc_k = render_mod.render_image(cfg, device=dev, kernel="cuda")
    check(mk.launch_counts()["raygen_launches"] > 0, "the kernel render launched no raygen_kernel")
    mk.reset_launch_counts()
    img_p, acc_p = render_mod.render_image(cfg, device=dev, kernel="torch")
    check(mk.launch_counts()["raygen_launches"] == 0, "the plain render launched raygen_kernel")
    mk_means = acc_k.reshape(-1, 3).double().mean(0)
    mp_means = acc_p.reshape(-1, 3).double().mean(0)
    rel = ((mk_means - mp_means).abs() / mp_means).max().item()
    check(rel < MEAN_RTOL, f"small render means {mk_means.tolist()} vs {mp_means.tolist()}")
    emit("render_vs_plain", scene="final_scene", size="96x54", spp=4, depth=12,
         mean_rel=rel, shape=list(img_k.shape))

    # ---- 5. main path ----
    cfg = RenderConfig(scene="final_scene", width=MAIN_W, height=MAIN_H,
                       samples_per_pixel=MAIN_SPP, max_depth=MAIN_DEPTH)
    main_caps = render_mod.adaptive_capacities("final_scene", bg, MAIN_DEPTH)
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
    main_batches = -(-MAIN_SPP // render_mod.batch_size(MAIN_W * MAIN_H, MAIN_SPP,
                                                        cfg.rays_per_chunk))
    main_raygen_launches = counts["raygen_launches"]
    # one a batch, one more for each batch whose compaction overflowed
    check(main_raygen_launches >= main_batches,
          f"main path: {main_raygen_launches} raygen launches for {main_batches} batches")
    check(counts["winners_launches"] == 0, "the render path launched winners")
    check(accum.shape == (MAIN_H, MAIN_W, 3) and img.shape == (MAIN_H, MAIN_W, 3),
          f"shape {tuple(accum.shape)}")
    check(bool(torch.isfinite(accum).all().item()), "non-finite framebuffer")
    check(float(accum.mean().item()) > 0.1 * MAIN_SPP, "framebuffer implausibly dark")
    main_img = img   # phase 22's input
    png = os.path.join(OUT_DIR, "chip_smoke_final_scene.png")
    image_mod.write_png(png, img)
    emit("main", scene="final_scene", width=MAIN_W, height=MAIN_H, spp=MAIN_SPP,
         depth=MAIN_DEPTH, wall_s=wall, primary_rays_per_s=MAIN_W * MAIN_H * MAIN_SPP / wall,
         launches=launches, raygen_launches=main_raygen_launches, batches=main_batches,
         peak_mem_bytes=torch.cuda.max_memory_allocated(), capacities=main_caps, png=png,
         card=card)

    # raygen_kernel at the main path's batch shape, against the PyTorch ops
    rcam = render_mod.camera_for_scene("final_scene", MAIN_W / MAIN_H, dev)
    rkw = dict(width=MAIN_W, height=MAIN_H, n_samples=1)
    host_cam = mk.camera_floats(rcam)

    def raygen():
        return mk.ray_state(rcam, 42, 0, host_camera=host_cam, **rkw)

    def raygen_plain():
        return mk.init_state(*batch_rays(rcam, 42, 0, **rkw))

    mk.reset_launch_counts()
    rg_got = raygen()
    check(mk.launch_counts()["raygen_launches"] == 1, "ray_state did not launch raygen_kernel")
    rg_want = raygen_plain()
    raygen_max_abs = (rg_got - rg_want).abs().max().item()
    check(torch.equal(rg_got.view(torch.int32), rg_want.view(torch.int32)),
          f"raygen_kernel's state differs from the PyTorch ops' (max abs {raygen_max_abs})")
    raygen_ms, raygen_host_ms = gpu_ms(raygen, 20)
    raygen_plain_ms = synced_ms(raygen_plain, 5)
    raygen_bound_ms = rg_got.numel() * rg_got.element_size() / HBM_BYTES_S * 1e3   # rows written
    emit("raygen", scene="final_scene", width=MAIN_W, height=MAIN_H, spp=1,
         rays=MAIN_W * MAIN_H, rows=rg_got.shape[0], bit_equal=True, ms=raygen_ms,
         host_ms=raygen_host_ms, plain_ms=raygen_plain_ms, bound_ms=raygen_bound_ms,
         roofline_share=raygen_bound_ms / raygen_ms, card=card)

    # ---- 6. where the main path's device time goes ----
    emit("profile", **profile_fn(lambda: render_mod.render_image(RenderConfig(
        scene="final_scene", width=MAIN_W, height=MAIN_H, samples_per_pixel=4,
        max_depth=MAIN_DEPTH)), spp=4), card=card)

    # ---- 7. every scene through the normal entry point ----
    variant_launches = {"noise": 0, "image": 0, "sky": 0}
    for name, p in SCENE_DEFAULTS.items():
        cfg = RenderConfig(scene=name, width=p["width"], height=p["height"],
                           samples_per_pixel=SCENES_SPP, max_depth=MAIN_DEPTH)
        caps = render_mod.adaptive_capacities(name, p["background"], MAIN_DEPTH)
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
             mean_radiance=float(accum.mean().item()) / SCENES_SPP, **counts,
             capacities=caps, png=png, card=card)

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
        w_ms, w_host_ms = gpu_ms(lambda: mk.trace_segment(
            wtab, wstate, 42, wbg, 0, depth, want_winners=True), 5)
        r_ms, _ = gpu_ms(lambda: mk.trace_segment(wtab, wstate, 42, wbg, 0, depth), 5)
        emit("winners_vs_plain", scene=name, rays=CMP_SIDE ** 2, depth=depth, **res,
             kernel_ms_winners=w_ms, kernel_host_ms_winners=w_host_ms,
             kernel_ms_radiance_only=r_ms, card=card)
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
         kernel_means=km.tolist(), replay_forward_ms=synced_ms(replay_fwd, 3), card=card)
    del keep, rep, ker, rk, wk

    # ---- 10. gradients through kernel winners vs plain winners ----
    def grad_check(name, width, height):
        """Loss gradients through kernel winners against plain winners, each
        scene under its own sky."""
        gscene = build_scene(name, device=dev)
        gcam = render_mod.camera_for_scene(name, width / height, dev)
        gbg = SCENE_DEFAULTS[name]["background"]
        grays = batch_rays(gcam, 42, 0, width=width, height=height, n_samples=GRAD_SPP)
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
    o, d, t, pid, sid = batch_rays(tcam, 42, 0, width=MAIN_W, height=MAIN_H, n_samples=1)
    pstate = mk.init_state(o, d, t, pid, sid)
    _, _, win_plain_ms, win_res = winners_check(
        mk, tables, pstate, bg, MAIN_DEPTH, f"pass-2 shape {pstate.shape[0]} lanes winners")
    win_ms, win_host_ms = gpu_ms(lambda: mk.trace_segment(
        tables, pstate, 42, bg, 0, MAIN_DEPTH, want_winners=True), 3)
    rad_ms, rad_host_ms = gpu_ms(
        lambda: mk.trace_segment(tables, pstate, 42, bg, 0, MAIN_DEPTH), 3)
    group, blocks = mk.trace_segment.last_shape
    rad_bnd = segment_bound(tables, scene, pstate, 42, bg, 0, MAIN_DEPTH, mk)
    # the winners output adds its bytes, written once
    win_bnd = dict(rad_bnd, bytes_ms=rad_bnd["bytes_ms"]
                   + MAIN_DEPTH * pstate.shape[0] * 4 / HBM_BYTES_S * 1e3)
    emit("winners_pass2_shape", lanes=pstate.shape[0], depth=MAIN_DEPTH, **win_res,
         kernel_ms_winners=win_ms, kernel_host_ms_winners=win_host_ms,
         kernel_ms_radiance_only=rad_ms, plain_ms=win_plain_ms, **win_bnd,
         bound_ms=max(win_bnd["ops_ms"], win_bnd["bytes_ms"]), group=group, blocks=blocks,
         card=card)
    # the same batch traced in one uncompacted launch against the render's
    # five compacted segments (data for choosing between them; the render
    # keeps its segments)
    one_bound = max(rad_bnd["ops_ms"], rad_bnd["bytes_ms"])
    emit("full_batch_one_launch", scene="final_scene", width=MAIN_W, height=MAIN_H,
         lanes=pstate.shape[0], depth=MAIN_DEPTH, kernel_ms=rad_ms,
         kernel_host_ms=rad_host_ms, bound_ms=one_bound, roofline_share=one_bound / rad_ms,
         live_ray_bounces=rad_bnd["live_ray_bounces"],
         segments=len(segs), segments_kernel_ms_sum=sum(sg["kernel_ms"] for sg in segs),
         segments_bound_ms_sum=sum(sg["bound_ms"] for sg in segs),
         segments_live_ray_bounces=sum(sg["live_ray_bounces"] for sg in segs), card=card)
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

    # ---- 13. the eager integrator against the kernel, then its render ----
    for name, aspect, atol in cmp_scenes:
        escene = build_scene(name, device=dev)
        ebg = SCENE_DEFAULTS[name]["background"]
        erays = rays(name, CMP_SIDE, aspect, CMP_SIDE * CMP_SIDE)
        rk = mk.trace_paths(mk.pack_scene(escene), *erays, 42, ebg, 8, kernel="cuda")
        mk.reset_launch_counts()
        re_ = integrator.trace_paths(escene, *erays, 42, ebg, 8)
        check(mk.launch_counts()["launches"] == 0, f"{name}: the eager path launched the kernel")
        torch.cuda.synchronize()
        res = compare(re_.t(), rk.t(), f"{name} eager vs kernel {CMP_SIDE ** 2} rays depth 8",
                      mean_atol=atol)
        emit("eager_vs_kernel", scene=name, rays=CMP_SIDE ** 2, depth=8, **res,
             eager_ms=synced_ms(lambda: integrator.trace_paths(escene, *erays, 42, ebg, 8), 2),
             card=card)
    del escene, erays, rk, re_
    torch.cuda.empty_cache()
    cfg = RenderConfig(scene="final_scene", width=MAIN_W, height=MAIN_H, samples_per_pixel=1,
                       max_depth=MAIN_DEPTH)
    _, k_accum = render_mod.render_image(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mk.reset_launch_counts()
    t0 = time.perf_counter()
    _, e_accum = render_mod.render_image(cfg, kernel="eager")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(mk.launch_counts()["launches"] == 0, "the eager render launched the kernel")
    check(bool(torch.isfinite(e_accum).all()), "eager render: non-finite framebuffer")
    em, km = e_accum.reshape(-1, 3).double().mean(0), k_accum.reshape(-1, 3).double().mean(0)
    check(bool(((em - km).abs() <= MEAN_RTOL * km.abs()).all()),
          f"eager render means {em.tolist()} vs kernel {km.tolist()}")
    emit("eager", scene="final_scene", width=MAIN_W, height=MAIN_H, spp=1, depth=MAIN_DEPTH,
         wall_s=wall, primary_rays_per_s=MAIN_W * MAIN_H / wall,
         peak_mem_bytes=torch.cuda.max_memory_allocated(), eager_means=em.tolist(),
         kernel_means=km.tolist(), card=card)
    del k_accum, e_accum
    torch.cuda.empty_cache()

    # ---- 14. float64 through the eager integrator, against float32 ----
    cb = SCENE_DEFAULTS["cornell_box"]   # 600x600
    for name, w, h, spp in (("cornell_box", cb["width"], cb["height"], 4),
                            ("final_scene", MAIN_W, MAIN_H, 1)):
        kw = dict(scene=name, width=w, height=h, samples_per_pixel=spp, max_depth=MAIN_DEPTH)
        _, a32 = render_mod.render_image(RenderConfig(**kw))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mk.reset_launch_counts()
        t0 = time.perf_counter()
        _, a64 = render_mod.render_image(RenderConfig(**kw, dtype="float64"))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(a64.dtype == torch.float64, f"{name}: float64 render returned {a64.dtype}")
        check(mk.launch_counts()["launches"] == 0, f"{name}: float64 launched the kernel")
        check(bool(torch.isfinite(a64).all()) and a64.max().item() > 0.0,
              f"{name}: float64 framebuffer not finite or black")
        # tests/test_f64.py:48-58's bars
        off = ((a32.double() - a64).abs() > 1e-3).double().mean().item()
        rel = abs(a32.double().mean().item() - a64.mean().item()) / a64.mean().item()
        check(off < 0.02, f"{name}: {off} of float32 entries off float64 by > 1e-3")
        check(rel <= 5e-3, f"{name}: float32 mean off float64 by {rel}")
        emit("f64", scene=name, width=w, height=h, spp=spp, depth=MAIN_DEPTH, wall_s=wall,
             primary_rays_per_s=w * h * spp / wall,
             peak_mem_bytes=torch.cuda.max_memory_allocated(), f32_off_frac=off,
             f32_mean_rel=rel, card=card)
        del a32, a64
        torch.cuda.empty_cache()

    # ---- 15. the adaptive schedule against the static one, every scene ----
    def overflows(name, caps):
        """Sample batches of the scene's 16-spp render whose compaction
        overflows `caps` (render() then re-traces them uncompacted)."""
        p = SCENE_DEFAULTS[name]
        w, h = p["width"], p["height"]
        tab = mk.pack_scene(build_scene(name, device=dev))
        ocam = render_mod.camera_for_scene(name, w / h, dev)
        batch = render_mod.batch_size(w * h, SCENES_SPP, 1 << 20)
        flags = [render_mod.render_batch_compact(
            tab, ocam, p["background"], 42, s0, torch.zeros((h, w, 3), device=dev), width=w,
            height=h, n_samples=min(batch, SCENES_SPP - s0), max_depth=MAIN_DEPTH,
            capacities=caps)[1] for s0 in range(0, SCENES_SPP, batch)]
        return int(torch.stack(flags).sum().item())

    for name, p in SCENE_DEFAULTS.items():
        cfg = RenderConfig(scene=name, width=p["width"], height=p["height"],
                           samples_per_pixel=SCENES_SPP, max_depth=MAIN_DEPTH)
        static = render_mod._capacities_for(p["background"])
        adaptive = render_mod.adaptive_capacities(name, p["background"], MAIN_DEPTH)
        walls, sched_launches, fb = {"adaptive": [], "static": []}, {}, {}
        for which in ("adaptive", "static", "static", "adaptive"):   # in turns
            torch.cuda.synchronize()
            mk.reset_launch_counts()
            t0 = time.perf_counter()
            # None: render_image's own schedule, the adaptive one
            _, fb[which] = render_mod.render_image(
                cfg, capacities=static if which == "static" else None)
            torch.cuda.synchronize()
            walls[which].append(time.perf_counter() - t0)
            sched_launches[which] = mk.launch_counts()["launches"]
        ovf = {"adaptive": overflows(name, adaptive), "static": overflows(name, static)}
        bit_equal = bool(torch.equal(fb["static"], fb["adaptive"]))
        # compaction is exact and a ray adds its radiance once, so the two
        # are bit-equal; a recovered batch is accum - compacted + uncompacted,
        # equal to rounding (tests/test_torch_render.py's recovery bar)
        if ovf["adaptive"] == ovf["static"] == 0:
            check(bit_equal, f"{name}: adaptive and static framebuffers not bit-equal")
        else:
            check(torch.allclose(fb["static"], fb["adaptive"], rtol=1e-5, atol=1e-6),
                  f"{name}: adaptive and static framebuffers differ past the recovery bar")
        emit("adaptive", scene=name, width=cfg.width, height=cfg.height, spp=SCENES_SPP,
             depth=MAIN_DEPTH, adaptive=adaptive, static=static, probe_s=probe_s[name],
             bit_equal=bit_equal, overflowed_batches=ovf,
             launches_adaptive=sched_launches["adaptive"],
             launches_static=sched_launches["static"],
             wall_s_adaptive=sum(walls["adaptive"]) / 2, wall_s_static=sum(walls["static"]) / 2,
             walls=walls, card=card)
    del fb

    # ---- 16. a checkpointed CLI render stopped after its first save, resumed ----
    ckpt = os.path.join(OUT_DIR, "chip_smoke_final_scene.ckpt")
    if os.path.exists(ckpt):
        os.unlink(ckpt)
    # one sample a batch (as at the default rays_per_chunk at 1200x675),
    # so the first save comes after 4 of the 16
    argv = [sys.executable, "-m", "rtweekend_tpu_torch.cli", "final_scene", "--width",
            str(MAIN_W), "--height", str(MAIN_H), "--spp", str(CKPT_SPP), "--max-depth",
            str(MAIN_DEPTH), "--rays-per-chunk",
            str(MAIN_W * MAIN_H), "--checkpoint", ckpt, "-o",
            os.path.join(OUT_DIR, "chip_smoke_ckpt.png")]
    t0 = time.perf_counter()
    proc = subprocess.Popen(argv, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    try:
        while not os.path.exists(ckpt) and proc.poll() is None:
            time.sleep(0.002)
        stopped = proc.poll() is None
        proc.kill()
    finally:
        _, err = proc.communicate()
    first_s = time.perf_counter() - t0
    check(stopped and os.path.exists(ckpt),
          f"checkpointed render ended before its first save: {err.decode()[-2000:]}")
    saved = checkpoint.load(ckpt)
    check(0 < saved.samples_done < CKPT_SPP,
          f"first save holds {saved.samples_done} of {CKPT_SPP} samples")
    t0 = time.perf_counter()
    done = subprocess.run(argv, capture_output=True, text=True)
    resume_s = time.perf_counter() - t0
    check(done.returncode == 0, f"resumed render failed: {done.stderr[-2000:]}")
    resumed = torch.from_numpy(checkpoint.load(ckpt).accum)
    check(checkpoint.load(ckpt).samples_done == CKPT_SPP, "resumed render did not finish")
    scene = build_scene("final_scene", device=dev)
    cam = render_mod.camera_for_scene("final_scene", MAIN_W / MAIN_H, dev)
    ref_path = os.path.join(OUT_DIR, "chip_smoke_uninterrupted.ckpt")
    if os.path.exists(ref_path):
        os.unlink(ref_path)
    mk.reset_launch_counts()
    full = checkpoint.render_resumable(scene, cam, "final_scene", MAIN_W, MAIN_H, CKPT_SPP,
                                       MAIN_DEPTH, SCENE_DEFAULTS["final_scene"]["background"],
                                       42, ref_path, rays_per_chunk=MAIN_W * MAIN_H).cpu()
    check(mk.launch_counts()["launches"] > 0, "the resumable render launched no kernel")
    check(torch.allclose(resumed, full, rtol=1e-6, atol=1e-6),
          "resumed render differs from the uninterrupted one")
    emit("checkpoint", scene="final_scene", width=MAIN_W, height=MAIN_H, spp=CKPT_SPP,
         depth=MAIN_DEPTH, stopped_at_samples=saved.samples_done, first_run_s=first_s,
         resume_run_s=resume_s, launches_uninterrupted=mk.launch_counts()["launches"],
         bit_equal=bool(torch.equal(resumed, full)),
         max_abs_diff=(resumed - full).abs().max().item(), card=card)

    # ---- 17. the CLI's metrics and profiler trace on the card ----
    mpath = os.path.join(OUT_DIR, "chip_smoke_metrics.jsonl")
    pdir = os.path.join(OUT_DIR, "chip_smoke_profile")
    if os.path.exists(mpath):
        os.unlink(mpath)
    shutil.rmtree(pdir, ignore_errors=True)
    mk.reset_launch_counts()
    check(cli.main(["cornell_box", "--spp", "4", "--adaptive-caps", "--metrics", mpath,
                    "--profile-dir", pdir, "-o", os.path.join(OUT_DIR, "chip_smoke_cli.png")])
          == 0, "CLI run failed")
    cli_launches = mk.launch_counts()["launches"]
    check(cli_launches > 0, "the CLI run launched no kernel")
    with open(mpath) as f:
        events = [json.loads(line) for line in f]
    names = [e["event"] for e in events]
    check(names[0] == "render_start" and names[-1] == "render_done"
          and names.count("batch_submitted") >= 1, f"metrics events {names}")
    check(events[0]["backend"] == dev.type and events[0]["use_pallas"] is True,
          f"render_start {events[0]}")
    traces = os.listdir(pdir)
    check(len(traces) == 1 and os.path.getsize(os.path.join(pdir, traces[0])) > 0,
          f"profiler traces {traces}")
    with open(os.path.join(pdir, traces[0])) as f:
        trace_events = json.load(f)["traceEvents"]
    n_dev = sum(1 for e in trace_events if e.get("cat") == "kernel")
    emit("cli_options", scene="cornell_box", events=names, render_done=events[-1],
         launches=cli_launches, trace=traces[0], trace_events=len(trace_events),
         trace_device_kernels=n_dev, card=card)
    # the trace read back by the report tool
    rep = trace_report.report(pdir)
    check(rep["device_total_s"] > 0, f"trace report: device total {rep['device_total_s']}")
    check(any("bounce_kernel" in k for k in rep["by_kernel"]),
          f"trace report: no bounce kernel in {list(rep['by_kernel'])}")
    emit("trace_report", **rep, card=card)

    # ---- 18. the eager train step ----
    tname = "golden_scene"
    tp = SCENE_DEFAULTS[tname]
    tscene = build_scene(tname, device=dev)
    tcam = render_mod.camera_for_scene(tname, tp["width"] / tp["height"], dev)
    target = shard.kernel_mean_image(tscene, tcam, tp["width"], tp["height"], TRAIN_EAGER_SPP,
                                     MAIN_DEPTH, tp["background"], 42)
    p0 = shard.extract_params(tscene)
    tscene = shard.merge_params(tscene, dict(p0, color=p0["color"] * 0.8))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mk.reset_launch_counts()
    tm = {}
    t0 = time.perf_counter()
    params, loss = shard.sharded_train_step(
        tscene, tcam, target, tp["width"], tp["height"], TRAIN_EAGER_SPP, MAIN_DEPTH,
        tp["background"], 42, lr=1.0, use_pallas=False, timings=tm)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    check(mk.launch_counts()["launches"] == 0, "the eager train step launched the kernel")
    before = shard.extract_params(tscene)
    grads = {k: before[k] - params[k] for k in params}   # lr = 1
    check(bool(torch.isfinite(loss).item()), "eager train step: loss not finite")
    for k, g in grads.items():
        check(bool(torch.isfinite(g).all()), f"eager train step: grad {k} not finite")
    for k in ("c0", "radius", "color"):
        check(grads[k].abs().sum().item() > 0, f"eager train step: zero {k} gradient")
    emit("train_eager_step", scene=tname, width=tp["width"], height=tp["height"],
         spp=TRAIN_EAGER_SPP, depth=MAIN_DEPTH, loss=loss.item(), wall_s=step_s, **tm,
         rays_per_block=shard.eager_rays_per_chunk(tscene, 1 << 20),
         peak_mem_bytes=torch.cuda.max_memory_allocated(),
         grad_l2={k: torch.linalg.norm(g.double()).item() for k, g in grads.items()},
         card=card)
    emit("profile_train_eager", **profile_fn(lambda: shard.sharded_train_step(
        tscene, tcam, target, tp["width"], tp["height"], TRAIN_EAGER_SPP, MAIN_DEPTH,
        tp["background"], 42, lr=1.0, use_pallas=False), what="one eager train step"),
        card=card)
    del params, grads, target
    torch.cuda.empty_cache()
    # its gradients against the kernel path's on the same paths, in float64
    # (in float32 a path's gradient through glass and the r=1000 ground's
    # coefficient rows is ill conditioned; the float32 numbers are reported)
    rel, same_frac = {}, {}
    for dtype in (torch.float64, torch.float32):
        gs = build_scene(tname, device=dev, dtype=dtype)
        gcam = render_mod.camera_for_scene(tname, GOLDEN_GRAD_W / GOLDEN_GRAD_H, dev, dtype)
        grays = batch_rays(gcam, 42, 0, width=GOLDEN_GRAD_W, height=GOLDEN_GRAD_H,
                           n_samples=GRAD_SPP)
        kwin = vjp.kernel_winners(build_scene(tname, device=dev), *[
            x.float() if x.is_floating_point() else x for x in grays], 42, tp["background"],
            GRAD_DEPTH, kernel="cuda")[1]
        _, ewin = integrator.path_decisions(gs, *grays, 42, GRAD_DEPTH)
        same = (ewin == kwin).all(0)

        def same_path_grads(trace):
            prm = {k: v.detach().clone().requires_grad_(True)
                   for k, v in shard.extract_params(gs).items()}
            rad = trace(shard.merge_params(gs, prm))
            sloss = (((rad - 0.5) ** 2).sum(1) * same).sum() / rad.shape[0]
            return dict(zip(prm, torch.autograd.grad(sloss, list(prm.values()))))

        ge = same_path_grads(lambda sc: integrator.trace_paths(
            sc, *grays, 42, tp["background"], GRAD_DEPTH, remat=True))
        gk = same_path_grads(lambda sc: trace_paths_replay_fast(
            sc, *grays, 42, tp["background"], kwin))
        rel[str(dtype).removeprefix("torch.")] = {k: rel_l2(ge[k], gk[k]) for k in ge}
        same_frac[str(dtype).removeprefix("torch.")] = same.double().mean().item()
        if dtype == torch.float64:
            check(same.double().mean().item() >= 0.99, "eager vs kernel: paths diverged")
            for k in ge:
                check(bool(torch.isfinite(ge[k]).all()), f"eager grad {k} not finite")
                check(rel["float64"][k] <= SAME_PATH_RTOL,
                      f"eager vs kernel-path same-path grad {k}: {rel['float64'][k]}")
    emit("train_eager_vs_kernel", scene=tname, size=f"{GOLDEN_GRAD_W}x{GOLDEN_GRAD_H}",
         spp=GRAD_SPP, depth=GRAD_DEPTH, same_path_frac=same_frac,
         rel_l2_same_path=rel, card=card)

    # ---- 19. multi-device: NCCL at world size 1, two gloo ranks on the card ----
    multidevice_phase(dev, card, main_caps)

    # ---- 20. parity: the BASELINE configs against the TPU's committed renders ----
    parity_phase(dev, card)

    # ---- 21. the tools: bench_scenes, bench, bench_scaling ----
    tools_phase(card)

    # ---- 22. the host image runtime: artifacts, plain encoders ----
    native_phase(card, main_img)

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
    raygen_entry = {
        "name": "raygen_kernel",
        "route": "cuda",
        "source": "rtweekend_tpu_torch/csrc/megakernel.cu",
        # port-only: the JAX package makes a batch's rays and state with
        # jnp ops (ops/camera.generate_rays, ops/pallas/megakernel._init_state)
        "replaces": None,
        "launches": main_raygen_launches,
        "max_abs_err": raygen_max_abs,
        "ms": raygen_ms,
        "plain_ms": raygen_plain_ms,
        "bound_ms": raygen_bound_ms,
        "bound_by": "bytes",
        "library_ms": None,
    }
    kernels = [
        entry("megakernel", launches, segs),
        winners_entry,
        entry("megakernel_noise", variant_launches["noise"], variant_segs["noise"]),
        entry("megakernel_image", variant_launches["image"], variant_segs["image"]),
        entry("megakernel_sky", variant_launches["sky"], variant_segs["sky"]),
        raygen_entry,
    ]
    for k in kernels:
        check(isinstance(k["launches"], int) and k["launches"] > 0,
              f"{k['name']}: launches {k['launches']!r} is not a positive count")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
