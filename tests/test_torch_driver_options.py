"""The render driver's options in rtweekend_tpu_torch against the JAX
package: the alive-fraction probe and the adaptive compaction schedule,
render_image's use of it, checkpoint and resume (in both directions
between the packages), JSON-lines metrics, profiler traces, PhaseTimer
and the CLI's flags.

The probe's JAX side runs op by op (jax.disable_jit): jitted, XLA
contracts multiply-adds into FMAs, and on glass and grazing rays that
last bit flips a path's survival, so one probe ray in a few hundred
differs and the schedule's fractions move by margin / probe rays. Op by
op both sides round every operation once and the schedules are equal.
"""

import importlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtweekend_tpu import checkpoint as jax_checkpoint
from rtweekend_tpu import cli as jax_cli
from rtweekend_tpu.models.builders import build_scene as jax_build_scene
from rtweekend_tpu.ops.camera import generate_rays as jax_generate_rays
from rtweekend_tpu.utils.metrics import MetricsLogger as JaxMetricsLogger
from rtweekend_tpu.utils.profiling import alive_fractions as jax_alive_fractions
from rtweekend_tpu_torch import checkpoint, cli
from rtweekend_tpu_torch import render as render_mod
from rtweekend_tpu_torch.config import SCENE_DEFAULTS, RenderConfig
from rtweekend_tpu_torch.models.builders import build_scene
from rtweekend_tpu_torch.ops.camera import generate_rays
from rtweekend_tpu_torch.render import adaptive_capacities, camera_for_scene, render
from rtweekend_tpu_torch.utils import profiling
from rtweekend_tpu_torch.utils.metrics import MetricsLogger

from test_torch_megakernel import one_torch_thread  # noqa: F401  (autouse)

# the module: the package's `render` attribute is the render function
jax_render_mod = importlib.import_module("rtweekend_tpu.render")

W = H = 16
SPP, DEPTH, SEED = 8, 3, 42
BG = (0.7, 0.8, 1.0)
PROBE = dict(probe_width=16)
PROBE_DEPTH = 10


@pytest.fixture
def jax_caps_cache():
    """The JAX package's schedule cache, restored afterwards: it is keyed
    by scene, depth and background only, so a small probe's schedule must
    not stay behind for a later caller."""
    saved = dict(jax_render_mod._ADAPTIVE_CAPS_CACHE)
    jax_render_mod._ADAPTIVE_CAPS_CACHE.clear()
    yield
    jax_render_mod._ADAPTIVE_CAPS_CACHE.clear()
    jax_render_mod._ADAPTIVE_CAPS_CACHE.update(saved)


def _probe_rays(name, w=16, spp=2):
    """adaptive_capacities's probe rays (square camera, seed 0) on both sides."""
    n = w * w
    pid = np.repeat(np.arange(n, dtype=np.int32), spp)
    sid = np.tile(np.arange(spp, dtype=np.int32), n)
    jcam = jax_render_mod.camera_for_scene(name, aspect_ratio=1.0)
    J = list(jax_generate_rays(jcam, w, w, jnp.asarray(pid), jnp.asarray(sid), jnp.uint32(0)))
    cam = camera_for_scene(name, 1.0, "cpu")
    P = list(generate_rays(cam, w, w, torch.from_numpy(pid), torch.from_numpy(sid), 0))
    return J + [jnp.asarray(pid), jnp.asarray(sid)], P + [torch.from_numpy(pid),
                                                          torch.from_numpy(sid)]


@pytest.mark.parametrize("name", ["final_scene", "cornell_box", "simple_light"])
def test_alive_fractions_match_jax(name):
    """The jitted JAX probe against the port's: within 0.5% of the rays at
    every bounce (its FMA flips a rare path)."""
    J, P = _probe_rays(name, w=32)
    want = np.asarray(jax_alive_fractions(jax_build_scene(name), *J, jnp.uint32(0),
                                          PROBE_DEPTH))
    got = profiling.alive_fractions(build_scene(name, device="cpu"), *P, 0, PROBE_DEPTH)
    assert got.dtype == torch.float32 and got.shape == (PROBE_DEPTH,)
    assert got[0] == 1.0 and (got[1:] <= got[:-1]).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=0.005)


@pytest.mark.parametrize("name", ["cornell_box", "simple_light", "final_scene"])
def test_adaptive_capacities_equal_jax(name, jax_caps_cache):
    bg = SCENE_DEFAULTS[name]["background"]
    with jax.disable_jit():
        want = jax_render_mod.adaptive_capacities(name, bg, PROBE_DEPTH, **PROBE)
    got = adaptive_capacities(name, bg, PROBE_DEPTH, **PROBE)
    assert got == want and len(got) > 0
    assert adaptive_capacities(name, bg, PROBE_DEPTH, **PROBE) is got   # cached


def test_render_image_uses_the_adaptive_schedule(monkeypatch):
    """The kernel path renders with adaptive_capacities's schedule when no
    capacities are given; the eager path has none; given ones pass."""
    seen = []
    real_render = render_mod.render

    def spy(*args, **kw):
        seen.append(kw["capacities"])
        return real_render(*args, **kw)

    monkeypatch.setattr(render_mod, "render", spy)
    cfg = RenderConfig(scene="cornell_box", width=8, height=8, samples_per_pixel=2,
                       max_depth=12)
    render_mod.render_image(cfg, device="cpu")
    render_mod.render_image(cfg, device="cpu", kernel="eager")
    render_mod.render_image(cfg, device="cpu", capacities=((4, 0.5),))
    want = adaptive_capacities("cornell_box", SCENE_DEFAULTS["cornell_box"]["background"], 12)
    assert want != render_mod._capacities_for((0.0, 0.0, 0.0))
    assert seen == [want, None, ((4, 0.5),)]


def _two_spheres():
    return (build_scene("two_spheres", device="cpu"),
            camera_for_scene("two_spheres", 1.0, "cpu"))


def test_checkpoint_save_load_roundtrip(tmp_path):
    st = checkpoint.RenderState(
        accum=np.random.default_rng(0).uniform(size=(4, 4, 3)).astype(np.float32),
        samples_done=5, meta={"scene": "x", "version": 1})
    p = str(tmp_path / "r.ckpt")
    checkpoint.save(p, st)
    back = checkpoint.load(p)
    np.testing.assert_array_equal(back.accum, st.accum)
    assert back.samples_done == 5 and back.meta == st.meta
    assert checkpoint.load(str(tmp_path / "missing.ckpt")) is None
    assert os.listdir(tmp_path) == ["r.ckpt"]   # no temporary file left


@pytest.mark.parametrize("kernel", ["auto", "eager"])
def test_resume_matches_uninterrupted(tmp_path, kernel):
    scene, cam = _two_spheres()
    p = str(tmp_path / "r.ckpt")
    kw = dict(rays_per_chunk=W * H * 2, kernel=kernel)
    full = render(scene, cam, W, H, SPP, DEPTH, BG, SEED, **kw)
    partial = render(scene, cam, W, H, 4, DEPTH, BG, SEED, **kw)
    checkpoint.save(p, checkpoint.RenderState(
        partial.numpy(), 4, checkpoint._meta("two_spheres", W, H, SPP, DEPTH, SEED)))
    resumed = checkpoint.render_resumable(scene, cam, "two_spheres", W, H, SPP, DEPTH, BG,
                                          SEED, p, **kw)
    torch.testing.assert_close(resumed, full, rtol=1e-6, atol=1e-6)
    done = checkpoint.load(p)
    assert done.samples_done == SPP
    np.testing.assert_array_equal(done.accum, resumed.numpy())


def test_stale_checkpoint_restarts(tmp_path):
    scene, cam = _two_spheres()
    p = str(tmp_path / "r.ckpt")
    checkpoint.save(p, checkpoint.RenderState(
        np.full((H, W, 3), 99.0, np.float32), 4,
        checkpoint._meta("two_spheres", W, H, SPP, DEPTH, 7)))   # another seed
    out = checkpoint.render_resumable(scene, cam, "two_spheres", W, H, SPP, DEPTH, BG, SEED,
                                      p, rays_per_chunk=W * H * 2)
    full = render(scene, cam, W, H, SPP, DEPTH, BG, SEED, rays_per_chunk=W * H * 2)
    torch.testing.assert_close(out, full, rtol=1e-6, atol=1e-6)


def test_checkpoint_periodic_saves(tmp_path, monkeypatch):
    """A save every checkpoint_every batches (never at the end of the
    loop, which saves once after recovery), each with the samples done."""
    scene, cam = _two_spheres()
    saved = []
    real_save = checkpoint.save
    monkeypatch.setattr(checkpoint, "save",
                        lambda path, st: (saved.append(st.samples_done), real_save(path, st)))
    checkpoint.render_resumable(scene, cam, "two_spheres", W, H, SPP, DEPTH, BG, SEED,
                                str(tmp_path / "r.ckpt"), rays_per_chunk=W * H,
                                checkpoint_every=3)
    assert saved == [3, 6, SPP]


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """A checkpoint written by the JAX package's save resumes here: the
    saved sums (offset by 1 so that a restart would show) plus samples
    4.. of the port's render."""
    scene, cam = _two_spheres()
    p = str(tmp_path / "r.ckpt")
    kw = dict(rays_per_chunk=W * H * 2)
    partial = render(scene, cam, W, H, 4, DEPTH, BG, SEED, **kw).numpy()
    jax_checkpoint.save(p, jax_checkpoint.RenderState(
        partial + 1.0, 4, jax_checkpoint._meta("two_spheres", W, H, SPP, DEPTH, SEED)))
    resumed = checkpoint.render_resumable(scene, cam, "two_spheres", W, H, SPP, DEPTH, BG,
                                          SEED, p, **kw)
    full = render(scene, cam, W, H, SPP, DEPTH, BG, SEED, **kw)
    torch.testing.assert_close(resumed, full + 1.0, rtol=1e-6, atol=1e-5)


def test_port_checkpoint_resumes_in_jax(tmp_path):
    """The reverse: the JAX package resumes a checkpoint the port saved
    (its last sample batch only, on its jnp path), keeping the saved sums."""
    p = str(tmp_path / "r.ckpt")
    checkpoint.save(p, checkpoint.RenderState(
        np.full((H, W, 3), 1000.0, np.float32), SPP - 1,
        checkpoint._meta("two_spheres", W, H, SPP, DEPTH, SEED)))
    jscene = jax_build_scene("two_spheres")
    jcam = jax_render_mod.camera_for_scene("two_spheres", aspect_ratio=1.0)
    out = np.asarray(jax_checkpoint.render_resumable(
        jscene, jcam, "two_spheres", W, H, SPP, DEPTH, BG, SEED, p, rays_per_chunk=W * H,
        use_pallas=False)) - 1000.0
    scene, cam = _two_spheres()
    last = render_mod.to_framebuffer(render_mod.render_range(
        scene, cam, W, H, (0, W * H), (SPP - 1, SPP), DEPTH, BG, SEED, kernel="eager"),
        W, H).numpy()
    assert (out > -1e-3).all() and out.max() > 0.1
    np.testing.assert_allclose(out.mean((0, 1)), last.mean((0, 1)), rtol=0.02)
    assert checkpoint.load(p).samples_done == SPP


def _events(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_metrics_events_match_jax(tmp_path):
    """The same render (cornell_box on the eager integrator and on the JAX
    jnp path) logs the same events with the same fields; the values agree
    but for times, rates and n_devices (the JAX suite runs 8 virtual CPU
    devices)."""
    kw = dict(width=W, height=H, samples_per_pixel=4, max_depth=DEPTH,
              rays_per_chunk=W * H * 2)
    with MetricsLogger(str(tmp_path / "port.jsonl")) as m:
        render_mod.render_image(RenderConfig(scene="cornell_box", **kw), device="cpu",
                                kernel="eager", metrics=m)
    with JaxMetricsLogger(str(tmp_path / "jax.jsonl")) as m:
        jax_render_mod.render_image(jax_render_mod.RenderConfig(scene="cornell_box", **kw),
                                    use_pallas=False, metrics=m)
    got, want = _events(tmp_path / "port.jsonl"), _events(tmp_path / "jax.jsonl")
    assert [e["event"] for e in got] == [e["event"] for e in want] == [
        "render_start", "batch_submitted", "batch_submitted", "render_done"]
    timing = {"ts", "t_s", "wall_s", "rays_per_s", "rays_per_s_per_device", "n_devices"}
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        assert {k: v for k, v in g.items() if k not in timing} == \
               {k: v for k, v in w.items() if k not in timing}
    assert got[0]["n_devices"] == 1 and got[0]["backend"] == "cpu"
    assert got[-1]["wall_s"] > 0 and got[-1]["rays_per_s"] > 0


def test_profiler_trace_is_written(tmp_path):
    d = tmp_path / "prof"
    with profiling.trace(str(d)):
        x = torch.ones(64) * 2.0
    with profiling.trace(None):
        x = x + 1.0
    (name,) = os.listdir(d)
    with open(d / name) as f:
        assert "traceEvents" in json.load(f)


def test_phase_timer_and_rays_per_second():
    t = profiling.PhaseTimer()
    for _ in range(2):
        with t.phase("render", block_on=torch.ones(3)):
            pass
    with t.phase("write", block_on=[torch.ones(1), torch.zeros(1)]):
        pass
    assert t.counts == {"render": 2, "write": 1}
    assert all(v >= 0.0 for v in t.totals.values())
    assert "render" in t.summary() and "over 2 calls" in t.summary()
    assert profiling.rays_per_second(1000, 0.5) == 2000.0


def _flags(parser):
    return {s for a in parser._actions for s in a.option_strings}


def test_cli_accepts_every_flag_of_the_jax_cli(tmp_path):
    assert _flags(jax_cli.build_parser()) <= _flags(cli.build_parser())
    out = tmp_path / "cb.png"
    rc = cli.main(["cornell_box", "--width", "8", "--height", "8", "--spp", "2",
                   "--max-depth", "3", "--seed", "3", "--rays-per-chunk", "64", "--cpu",
                   "--dtype", "float64", "--kernel", "eager", "--adaptive-caps", "--ppm",
                   "--metrics", str(tmp_path / "m.jsonl"),
                   "--profile-dir", str(tmp_path / "prof"), "-o", str(out)])
    assert rc == 0 and out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert (tmp_path / "cb.ppm").exists()
    assert [e["event"] for e in _events(tmp_path / "m.jsonl")][-1] == "render_done"
    assert os.listdir(tmp_path / "prof")
    # --checkpoint renders resumably and leaves the finished state
    ck = tmp_path / "r.ckpt"
    rc = cli.main(["two_spheres", "--width", "8", "--height", "8", "--spp", "2",
                   "--max-depth", "3", "--cpu", "--checkpoint", str(ck), "-o", str(out)])
    assert rc == 0 and checkpoint.load(str(ck)).samples_done == 2


def _schedule_cost(fracs, sched, depth, margin=2.5, penalty=0.5, min_frac=0.004):
    """adaptive_capacities's objective for the boundaries of `sched` under
    `fracs`: each segment's capacity times its length, plus a penalty a
    boundary (the capacities are re-derived from fracs)."""
    bounds = [0] + [b for b, _ in sched] + [depth]
    caps = [1.0] + [max(min(margin * fracs[b], 1.0), min_frac) for b, _ in sched]
    return sum(c * (e - s) for c, s, e in zip(caps, bounds, bounds[1:])) + penalty * len(sched)


def main(names=("final_scene", "golden_scene"), depth=50):
    """Print, at adaptive_capacities's default probe (64x64 x 2 spp, seed
    0), the JAX package's fractions (jitted, as its adaptive_capacities
    runs them) and the port's, how many probe rays apart they are (also
    against JAX run op by op), both schedules, and each schedule's cost
    under either fraction vector. From the repo root: `PYTHONPATH=.
    JAX_PLATFORMS=cpu python tests/test_torch_driver_options.py`."""
    torch.set_num_threads(1)
    for name in names:
        bg = SCENE_DEFAULTS[name]["background"]
        J, _ = _probe_rays(name, w=64)
        jf = [float(x) for x in np.asarray(jax_alive_fractions(
            jax_build_scene(name), *J, jnp.uint32(0), depth))]
        with jax.disable_jit():
            jo = [float(x) for x in np.asarray(jax_alive_fractions(
                jax_build_scene(name), *J, jnp.uint32(0), depth))]
        pf = render_mod.probe_fractions(name, depth)
        js = tuple((b, float(c)) for b, c in jax_render_mod.adaptive_capacities(name, bg, depth))
        ps = adaptive_capacities(name, bg, depth)
        n_rays = 64 * 64 * 2
        print(json.dumps(dict(
            scene=name, depth=depth, probe_rays=n_rays, jax_fractions=jf, port_fractions=pf,
            rays_apart=[round(abs(a - b) * n_rays) for a, b in zip(jf, pf)],
            rays_apart_op_by_op=[round(abs(a - b) * n_rays) for a, b in zip(jo, pf)],
            jax_schedule=js, port_schedule=ps,
            cost_under_jax_fractions=dict(jax=_schedule_cost(jf, js, depth),
                                          port=_schedule_cost(jf, ps, depth)),
            cost_under_port_fractions=dict(jax=_schedule_cost(pf, js, depth),
                                           port=_schedule_cost(pf, ps, depth)))))


if __name__ == "__main__":
    main()
