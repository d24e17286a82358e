"""The per-layer readers and the trace reduction on small synthetic
profiler events, and the reduction of a real (CPU) profile."""

import pytest
import torch

from benchmark import harness, roofline, trace


def _events():
    """A 10 ms window: two kernel launches (2 ms, 1 ms), one copy (1 ms)
    overlapping the second launch by 0.5 ms, host ops around them, and
    the device timeline's mirror of a host span, which is no device
    operation. (name, on_device, start_ns, end_ns, thread)."""
    ms = 1_000_000
    return [
        (trace.WINDOW, False, 0, 10 * ms, 1),
        ("render_image", False, 0, 8 * ms, 1),
        ("aten::nonzero", False, 3 * ms, 5 * ms, 1),
        ("write_png", False, 8 * ms, 10 * ms, 1),
        ("aten::other_thread", False, 0, 10 * ms, 2),
        ("render_image", True, 0, 8 * ms, 7),
        ("bounce_kernel(Params)", True, 1 * ms, 3 * ms, 7),
        ("bounce_kernel(Params)", True, 5 * ms, 6 * ms, 7),
        ("Memcpy DtoH", True, 5 * ms + ms // 2, 6 * ms + ms // 2, 8),
        ("outside", True, 20 * ms, 21 * ms, 7),
    ]


def test_trace_reduction():
    tr = trace.from_events(_events())
    assert tr.window_s == pytest.approx(0.010)
    assert tr.busy_s() == pytest.approx(0.0035)     # [1, 3] + [5, 6.5] ms
    by = tr.device_s_by_name()
    assert by["bounce_kernel(Params)"] == pytest.approx(0.003)
    assert "outside" not in by and "render_image" not in by
    gaps = tr.idle_gaps()
    assert [(round(a * 1e3, 6), round(b * 1e3, 6)) for a, b in gaps] == [
        (0.0, 1.0), (3.0, 5.0), (6.5, 10.0)]
    idle = tr.idle_by_host_op()
    # gap midpoints 0.5 ms (render_image), 4 ms (nonzero), 8.25 ms (write_png)
    assert idle == pytest.approx({"render_image": 0.001, "aten::nonzero": 0.002,
                                  "write_png": 0.0035})
    bd = tr.breakdown()
    assert bd["idle_gaps"][0][0] == "write_png" and len(bd["device_ops"]) == 2


def test_from_profiler_reads_a_real_profile():
    """The path every traced run takes, on the host's own events (this
    build has no device timeline)."""
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    with torch.profiler.record_function(trace.WINDOW):
        with torch.profiler.record_function("write_png"):
            torch.ones(4096).cumsum(0)
    prof.stop()
    tr = trace.from_profiler(prof)
    names = {n for _, _, n in tr.host}
    assert tr.window_s > 0.0 and tr.device == [] and tr.idle_pct() is None
    assert "write_png" in names and "aten::cumsum" in names and trace.WINDOW not in names
    assert all(0.0 <= a <= b <= tr.window_s for a, b, _ in tr.host)


def _ctx(cell, stats, work=None, tr=None):
    man, _, cfg, wl, _ = harness.cell_parts(cell)
    return harness.Context(cell, cfg, wl, stats, tr or trace.from_events(_events()), work or {})


def test_idle_readers():
    for name, cell in (("device_idle_pct.render", "final_scene.render"),
                       ("device_idle_pct.preview", "final_scene.preview"),
                       ("device_idle_pct.train", "golden_scene.train")):
        assert harness.reader(name)(_ctx(cell, {})) == pytest.approx(65.0)
    empty = trace.Trace(window_s=1.0, device=[], host=[])
    assert harness.reader("device_idle_pct.render")(_ctx("final_scene.render", {}, tr=empty)) \
        is None


def test_render_readers():
    stats = {"frames": 2, "png_s": [0.08, 0.10], "probe_s": 3.5}
    glue = harness.reader("glue_ms_per_frame.render")(_ctx("final_scene.render", stats))
    assert glue == pytest.approx(0.5)               # 1 ms of copy over 2 frames
    assert harness.reader("png_write_ms.preview")(_ctx("final_scene.preview", stats)) == \
        pytest.approx(90.0)
    assert harness.reader("schedule_probe_s")(_ctx("final_scene.render", stats)) == 3.5


def test_roofline_reader():
    work = {"rays": 1000, "live_ray_bounces": 2810, "live_misses": 900, "spheres": 485}
    stats = {"frames": 2}
    ctx = _ctx("final_scene.render", stats, work)
    got = harness.reader("bounce_kernel_roofline_pct.render")(ctx)
    rays = 2 * 1200 * 675 * 500
    least = roofline.least_seconds(rays=rays, live_ray_bounces=2.81 * rays,
                                   live_misses=0.9 * rays, spheres=485, frames=2)
    assert got == pytest.approx(100.0 * least["least_s"] / 0.003)
    # no kernel in the trace: nothing to read, never 0
    tr = trace.Trace(window_s=1.0, device=[(0.0, 0.1, "elementwise")], host=[])
    assert harness.reader("bounce_kernel_roofline_pct.render")(
        _ctx("final_scene.render", stats, work, tr)) is None


def test_train_readers():
    stats = {"timings": [{"pass1_s": 0.02, "winners_s": 0.03, "replay_s": 1.0},
                         {"pass1_s": 0.04, "winners_s": 0.01, "replay_s": 1.2}]}
    ctx = _ctx("golden_scene.train", stats)
    assert harness.reader("replay_s_per_step.train")(ctx) == pytest.approx(1.1)
    assert harness.reader("kernel_passes_s_per_step.train")(ctx) == pytest.approx(0.05)
    assert harness.reader("replay_s_per_step.train")(_ctx("golden_scene.train", {})) is None
