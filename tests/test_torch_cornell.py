"""The Cornell box on the port's plain path (CPU): render_image against the
benchmark's rect reference (benchmark/reference/rect_tracer.py, which
solves each rect in its RotateY and Translate instance's frame, as the
reference ray tracer does), and the overflow recovery's re-trace counter.
The file imports no JAX."""

import numpy as np
import pytest
import torch

from benchmark.jobs.render_frames import tone_map
from benchmark.reference import camera, rect_scenes, rect_tracer
from rtweekend_tpu_torch import render as render_mod
from rtweekend_tpu_torch.config import SCENE_DEFAULTS, RenderConfig
from rtweekend_tpu_torch.models.builders import build_scene
from rtweekend_tpu_torch.ops.cuda import megakernel as mk

SEED = 2**31 + 5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One PyTorch thread while the module runs (the suite runs one xdist
    worker a core; see tests/test_torch_megakernel.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_plain_render_matches_the_rect_reference():
    """Tone-mapped levels within 1 (float32 against float64 tone maps) on
    all but at most 1% of pixels: the port bakes each box's RotateY and
    Translate into its rows, the reference solves the plane in the
    instance's frame, so t and the hit point differ by rounding and a ray
    that meets a box edge, or leaves a point just behind a face at a
    grazing angle, may take another path."""
    w = h = 16
    spp, depth = 4, 8
    img, accum = render_mod.render_image(
        RenderConfig("cornell_box", w, h, spp, depth, seed=SEED), device="cpu",
        capacities=mk.CAPS_CLOSED)
    d = SCENE_DEFAULTS["cornell_box"]
    sc = rect_tracer.scene_tensors(rect_scenes.build("cornell_box"), "cpu")
    cam = camera.camera(d["look_from"], d["look_at"], d["vfov"], w / h, d["aperture"])
    pid = torch.arange(w * h, dtype=torch.int32).repeat_interleave(spp)
    sid = torch.arange(spp, dtype=torch.int32).repeat(w * h)
    o, dd, t = camera.rays(cam, w, h, pid, sid, SEED)
    rad = rect_tracer.trace(sc, o, dd, t, pid, sid, SEED, d["background"], depth)
    sums = rad.double().reshape(w * h, spp, 3).sum(1).numpy()
    ref = tone_map(sums, spp).reshape(h, w, 3)[::-1]
    off = (np.abs(ref - img.astype(np.int64)) > 1).any(axis=-1).mean()
    assert off <= 0.01, off
    assert torch.isfinite(accum).all() and img.mean() > 10.0


def test_overflow_retraces_are_counted(monkeypatch):
    """recover re-traces exactly the batches whose compaction overflowed,
    counts each in launch_counts()["retrace_launches"] and names each in a
    trace (an "overflow_retrace" span), and the recovered frame is the
    uncompacted one."""
    w = h = 32
    spp, depth, caps = 4, 4, ((2, 0.1),)
    scene = build_scene("cornell_box", device="cpu")
    cam = render_mod.camera_for_scene("cornell_box", 1.0, "cpu")
    bg = SCENE_DEFAULTS["cornell_box"]["background"]
    kw = dict(rays_per_chunk=2 * w * h)   # 2 samples a batch: 2 batches
    tables = mk.pack_scene(scene)
    flags = [mk.trace_paths_compact(tables, mk.ray_state(cam, SEED, s, width=w, height=h,
                                                         n_samples=2),
                                    2 * w * h, SEED, bg, depth, capacities=caps)[1].item()
             for s in (0, 2)]
    assert any(flags)
    spans = []
    real_span = torch.profiler.record_function

    def span(name, *args):
        spans.append(name)
        return real_span(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", span)
    before = mk.launch_counts()["retrace_launches"]
    fb = render_mod.render(scene, cam, w, h, spp, depth, bg, SEED, capacities=caps, **kw)
    assert mk.launch_counts()["retrace_launches"] - before == sum(flags)
    assert spans.count("overflow_retrace") == sum(flags)
    want = render_mod.render(scene, cam, w, h, spp, depth, bg, SEED, capacities=(), **kw)
    assert mk.launch_counts()["retrace_launches"] - before == sum(flags)
    torch.testing.assert_close(fb, want, rtol=1e-5, atol=1e-6)
