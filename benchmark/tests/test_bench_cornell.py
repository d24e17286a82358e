"""The Cornell box cell on the CPU: the rect reference's scene against the
program's build, its trace against the program's plain path at a tiny
size, its metric readers, and whole runs of the cell's job at a tiny size
(sound runs correct; the control and each planted fault not)."""

import time

import numpy as np
import pytest
import torch

from benchmark import faults, harness, roofline, trace
from benchmark.jobs.render_frames import tone_map
from benchmark.reference import camera, rect_scenes, rect_tracer

pytestmark = pytest.mark.usefixtures("one_torch_thread")
SEED = 3_000_000_019
CELL = "cornell_box.render"
TINY = dict(cfg=dict(width=16, height=16, max_depth=8),
            wl=dict(spp=8, warm_spp=2, check_frames=2, check_pixels=200,
                    limits={"off2_pct": 1.0, "mean_abs_diff": 0.2}))


def test_rects_equal_the_program_build():
    """The reference keeps RotateY and Translate beside each rect; the
    program bakes them into object-space rows. Mapped to world space, the
    corners and outward normals agree within float32 rounding."""
    from rtweekend_tpu_torch.models.builders import build_scene

    ref = rect_scenes.build("cornell_box")
    corners, normals = rect_scenes.world_corners(ref)
    rc = build_scene("cornell_box", device="cpu").rects
    r = ref["n_rects"]
    assert r == 18 and int(rc.active.sum()) == r and bool(rc.active[:r].all())
    # the program's rows w_q . p + b_q = q are orthonormal: p = W^T (q - b)
    w = torch.stack([rc.wn, rc.wa, rc.wb], dim=1)[:r].double().numpy()
    bias = torch.stack([rc.bn, rc.ba, rc.bb], dim=1)[:r].double().numpy()
    lo = np.stack([rc.a0, rc.b0], 1)[:r].astype(np.float64)
    hi = np.stack([rc.a1, rc.b1], 1)[:r].astype(np.float64)
    k = rc.k[:r].double().numpy()
    for c, (ia, ib) in enumerate(((0, 0), (1, 0), (1, 1), (0, 1))):
        q = np.stack([k, (lo, hi)[ia][:, 0], (lo, hi)[ib][:, 1]], axis=1)
        p = np.einsum("rqi,rq->ri", w, q - bias)
        np.testing.assert_allclose(p, corners[:, c], rtol=0, atol=555.0 * 2**-22)
    np.testing.assert_allclose(rc.normal[:r].double().numpy(), normals, rtol=0, atol=2**-22)
    mats = build_scene("cornell_box", device="cpu").materials
    np.testing.assert_array_equal(mats.mtype[rc.mat_id[:r].long()].numpy(),
                                  ref["mtype"][ref["rect_mat"]])


def _reference_levels(w, h, spp, depth, seed, march="fp32", counts=None):
    from rtweekend_tpu_torch.config import SCENE_DEFAULTS

    d = SCENE_DEFAULTS["cornell_box"]
    sc = rect_tracer.scene_tensors(rect_scenes.build("cornell_box"), "cpu")
    cam = camera.camera(d["look_from"], d["look_at"], d["vfov"], w / h, d["aperture"])
    pid = torch.arange(w * h, dtype=torch.int32).repeat_interleave(spp)
    sid = torch.arange(spp, dtype=torch.int32).repeat(w * h)
    o, dd, t = camera.rays(cam, w, h, pid, sid, seed)
    rad = rect_tracer.trace(sc, o, dd, t, pid, sid, seed, d["background"], depth,
                            march=march, counts=counts)
    return tone_map(rad.double().reshape(w * h, spp, 3).sum(1).numpy(), spp).reshape(h, w, 3)[::-1]


def test_reference_counts_and_control():
    """The reference's own trace at a tiny size: the light reaches the
    walls, it counts live ray-bounces and misses for the roofline reader,
    and one precision step down (the TF32 control) its plane solve puts
    hit points visibly off. Its levels against the program's plain path
    are tests/test_torch_cornell.py's."""
    w = h = 16
    spp, depth = 4, 8
    counts = {}
    ref = _reference_levels(w, h, spp, depth, SEED, counts=counts)
    assert ref.mean() > 10.0
    assert counts["live_ray_bounces"] > w * h * spp and counts["live_misses"] > 0
    tf = _reference_levels(w, h, spp, depth, SEED, march="tf32")
    assert (np.abs(tf - ref) > 2).any(axis=-1).mean() > 0.01


def test_spheres_and_rects_together():
    """With a sphere among the rects, the sphere's hits (its coefficient
    form, reference.tracer.closest) and the rects' agree with the program's
    plain path on one scene: a glass ball in the Cornell box."""
    from rtweekend_tpu_torch.models import scene as ps
    from rtweekend_tpu_torch.models.builders import cornell_box
    from rtweekend_tpu_torch.ops.cuda import megakernel as mk
    from rtweekend_tpu_torch.ops.camera import generate_rays
    from rtweekend_tpu_torch.render import camera_for_scene

    b = ps.SceneBuilder()
    cornell_box(b, np.random.default_rng(0))
    glass = b.material(ps.Dielectric(ir=1.5))
    b.add_sphere((190.0, 90.0, 190.0), 90.0, glass)
    tables = mk.pack_scene(b.build("cpu"))
    ref = rect_tracer.scene_tensors(rect_scenes.build("cornell_box"), "cpu")
    ref.update(c0=torch.tensor([[190.0, 90.0, 190.0]]), dc=torch.zeros(1, 3),
               time0=torch.zeros(1), inv_dt=torch.ones(1), radius=torch.tensor([90.0]),
               mat_id=torch.tensor([4]), n_spheres=1,
               mtype=torch.cat([ref["mtype"], torch.tensor([2])]),
               tex_id=torch.cat([ref["tex_id"], torch.tensor([0])]),
               fuzz=torch.cat([ref["fuzz"], torch.zeros(1)]),
               ior=torch.cat([ref["ior"], torch.tensor([1.5])]))
    n = 4096
    pid = torch.arange(n, dtype=torch.int32) % 1024
    sid = torch.div(torch.arange(n, dtype=torch.int32), 1024, rounding_mode="floor")
    rays = generate_rays(camera_for_scene("cornell_box", 1.0, "cpu"), 32, 32, pid, sid, SEED)
    want = mk.trace_paths(tables, *rays, pid, sid, SEED, (0.0, 0.0, 0.0), 8, kernel="torch")
    got = rect_tracer.trace(ref, *rays, pid, sid, SEED, (0.0, 0.0, 0.0), 8)
    diverged = ((got - want).abs() > 1e-3).any(dim=1).float().mean().item()
    assert diverged < 0.01, diverged
    torch.testing.assert_close(got.mean(0), want.mean(0), rtol=0.05, atol=0.0)


def _ctx(stats, work=None, tr=None):
    man, _, cfg, wl, _ = harness.cell_parts(CELL)
    ms = 1_000_000
    tr = tr or trace.from_events([
        (trace.WINDOW, False, 0, 10 * ms, 1),
        ("void bounce_kernel<0, false>(Params)", True, 1 * ms, 3 * ms, 7),
        ("index_add", True, 4 * ms, 5 * ms, 7)])
    return harness.Context(CELL, cfg, wl, stats, tr, work or {})


def test_readers():
    """The Cornell cell's own readers. Its glue and idle are read by the
    .render readers, whose arithmetic test_bench_metrics.py holds."""
    stats = {"frames": 2, "launches": {"launches": 1000, "retrace_launches": 3}}
    work = {"rays": 1000, "live_ray_bounces": 6400, "live_misses": 900, "rects": 18,
            "spheres": 0}
    roof = harness.reader("bounce_kernel_roofline_pct.cornell")
    retrace = harness.reader("retrace_launches_per_frame.cornell")
    assert retrace(_ctx(stats)) == 1.5
    # 2 frames of 72 M rays, 6.4 live bounces a ray, 18 rects at 41 FLOP:
    # ops-bound, against the trace's 2 ms of kernel
    rays = 2 * 600 * 600 * 200
    ops_s = 6.4 * rays * 18 * 41 / roofline.FP32_FLOPS
    assert ops_s > rays * 17 * 4 / roofline.HBM_BYTES_S
    assert roof(_ctx(stats, work)) == pytest.approx(100.0 * ops_s / 0.002)
    # a fifth of what the dense 6 rows of 17 coefficients a rect would count
    dense = roofline.least_seconds(rays=rays, live_ray_bounces=6.4 * rays,
                                   live_misses=0.9 * rays, spheres=0, rects=18, frames=2)
    assert ops_s / dense["least_s"] == pytest.approx(41 / 204)
    # a program without the counter, or a trace without the kernel: no number
    old = {"frames": 2, "launches": {"launches": 500}}
    assert retrace(_ctx(old)) is None
    none = trace.Trace(window_s=1.0, device=[(0.0, 0.1, "elementwise")], host=[])
    assert roof(_ctx(stats, work, none)) is None
    for name in ("glue_ms_per_frame.render", "device_idle_pct.render", "schedule_probe_s"):
        assert CELL in next(m for m in harness.manifest()["per_layer"]
                            if m["name"] == name)["workloads"]


def _parts():
    man, entry, cfg, wl, job = harness.cell_parts(CELL)
    return man, entry, dict(cfg, **TINY["cfg"]), dict(wl, **TINY["wl"]), job


def _run(**kw):
    detail = {}
    r = harness.run_cell(CELL, SEED, 0.3, False, t_start=time.perf_counter(), device="cpu",
                         parts=_parts(), detail=detail, **kw)
    return r, detail


def test_sound_run_is_correct():
    r, detail = _run()
    assert r["correct"], r["compared"]
    assert r["attempted"] >= 2 and r["failed"] == 0
    assert set(r["metrics"]) == {"render_rays_per_s", "setup_s"}
    # the window's counter deltas: on the CPU no kernel launches
    assert detail["launches"]["retrace_launches"] == 0


def test_control_is_not_correct():
    r, _ = _run(control=True)
    assert not r["correct"], r["compared"]


@pytest.mark.parametrize("fault", faults.FAULTS["render_frames"])
def test_planted_fault_is_not_correct(fault):
    with faults.planted(fault):
        r, _ = _run()
    assert not r["correct"], (fault, r["compared"])
