"""Card-only tests of rtweekend_tpu_torch's CUDA bounce kernel and of the
paths beside it on the card (the eager integrator, float64, resume, the
adaptive schedule).

They skip without a CUDA device. The file imports no JAX, so on the
card it runs without the suite's JAX set-up in tests/conftest.py:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

The kernel and the plain version sum the 17-term coefficient dots with
and without fused multiply-adds, which can flip a discrete decision on a
rare ray (tests/test_pallas.py's final_scene bars apply): at most 0.5%
of lanes off by more than 1e-3, channel means within 2% (plus atol 5e-3
for the noise and image scenes, tests/test_pallas.py:90-102).
"""

import numpy as np
import pytest
import torch

from rtweekend_tpu_torch import checkpoint
from rtweekend_tpu_torch import render as render_mod
from rtweekend_tpu_torch.config import SCENE_DEFAULTS, RenderConfig
from rtweekend_tpu_torch.ops import integrator
from rtweekend_tpu_torch.models import scene as port_scene
from rtweekend_tpu_torch.models.builders import _procedural_earth_rgba, build_scene
from rtweekend_tpu_torch.ops.camera import batch_rays, generate_rays
from rtweekend_tpu_torch.ops.cuda import megakernel as mk
from rtweekend_tpu_torch.parallel.shard import extract_params, sharded_train_step
from rtweekend_tpu_torch.render import camera_for_scene, render_image

SEED = 42
pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rays(name, aspect, n, device):
    ids = torch.from_numpy(np.arange(n, dtype=np.int32)).to(device)
    pid, sid = ids % 1024, torch.div(ids, 1024, rounding_mode="floor")
    cam = camera_for_scene(name, aspect, device)
    return (*generate_rays(cam, 32, 32, pid, sid, SEED), pid, sid)


SKY = ((1.0, 1.0, 1.0), (0.5, 0.7, 1.0))   # golden_scene's gradient sky


def mixed_scene(m):
    """A SceneBuilder of module m (the port's models.scene, or the JAX
    package's, which has the same builder) whose scene needs the noise,
    image and motion variants at once, none of the built-in scenes does:
    a noise ground, an image-textured sphere and rect (rect UV), a moving
    Lambertian sphere and a glass sphere. Under a sky it takes the
    kernel's general instantiation. (A fuzzy metal sphere moving over the
    noise ground mirrors the turbulence at 64x its base frequency and
    puts 0.72% of lanes past the lane bar against the JAX kernel on the
    CPU: hence Lambertian.)"""
    b = m.SceneBuilder()
    img = m.ImageTex(data=_procedural_earth_rgba((64, 128)))
    b.add_sphere((0.0, -1000.0, 0.0), 1000.0, b.material(m.Diffuse(albedo=m.Noise(scale=4.0))))
    b.add_sphere((0.0, 2.0, 0.0), 2.0, b.material(m.Diffuse(albedo=img)))
    b.add_rect("yz", 0.5, 3.5, -4.0, -1.0, 1.0, b.material(m.Diffuse(albedo=img)))
    b.add_moving_sphere((2.5, 0.6, 2.0), (2.5, 1.0, 2.0), 0.0, 1.0, 0.6,
                        b.material(m.Diffuse(albedo=m.Solid((0.8, 0.3, 0.2)))))
    b.add_sphere((1.5, 0.5, -2.5), 0.5, b.material(m.Dielectric(ir=1.5)))
    return b


def tie_scene(m):
    """A SceneBuilder of module m (the port's models.scene or the JAX
    package's) with exact ties: a sphere duplicated in the same place and a
    rect duplicated in the same place, each copy with its own color, over a
    ground sphere. The copies have identical coefficient rows, so their t
    are equal on every ray, and the lower index (the first copy) must win
    (megakernel.py:576-581)."""
    b = m.SceneBuilder()
    ground = b.material(m.Diffuse(albedo=m.Solid((0.5, 0.5, 0.5))))
    b.add_sphere((0.0, -1000.0, 0.0), 1000.0, ground)
    for color in ((0.8, 0.2, 0.2), (0.2, 0.8, 0.2)):
        b.add_sphere((0.0, 2.0, 0.0), 2.0, b.material(m.Diffuse(albedo=m.Solid(color))))
    for color in ((0.2, 0.2, 0.8), (0.8, 0.8, 0.2)):
        b.add_rect("xy", -6.0, 6.0, 0.0, 5.0, -3.0, b.material(m.Diffuse(albedo=m.Solid(color))))
    return b


# indices of the second copies in tie_scene: sphere 2, and the second rect
TIE_LOSERS = lambda s_pad: (2, s_pad + 1)  # noqa: E731
TIE_WINNERS = lambda s_pad: (1, s_pad)  # noqa: E731


# (scene, aspect, variant counter, means atol)
KERNEL_CASES = {
    "final_scene": (16 / 9, None, 0.0),
    "cornell_box": (1.0, None, 0.0),
    "two_perlin_spheres": (1.5, "noise_launches", 5e-3),
    "simple_light": (1.5, "noise_launches", 5e-3),
    "earth": (1.5, "image_launches", 5e-3),
    "golden_scene": (1.5, "sky_launches", 0.0),
}


@pytest.mark.parametrize("name", list(KERNEL_CASES))
def test_kernel_vs_plain_on_card(dev, name):
    aspect, counter, atol = KERNEL_CASES[name]
    tables = mk.pack_scene(build_scene(name, device=dev))
    rays = _rays(name, aspect, 8192, dev)
    bg = SCENE_DEFAULTS[name]["background"]
    before = mk.launch_counts()
    got = mk.trace_paths(tables, *rays, SEED, bg, 8, kernel="cuda")
    after = mk.launch_counts()
    assert after["launches"] == before["launches"] + 1
    if counter is not None:
        assert after[counter] == before[counter] + 1
    want = mk.trace_paths(tables, *rays, SEED, bg, 8, kernel="torch")
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    diverged = ((got - want).abs() > 1e-3).float().mean().item()
    assert diverged < 0.005, diverged
    torch.testing.assert_close(got.mean(0), want.mean(0), rtol=0.02, atol=atol)


def test_general_instantiation_vs_plain_on_card(dev):
    """A scene with noise, image, motion and the gradient sky at once
    takes the kernel's general instantiation."""
    scene = mixed_scene(port_scene).build(dev)
    assert scene.has_noise and scene.has_image and scene.has_motion
    tables = mk.pack_scene(scene)
    rays = _rays("two_perlin_spheres", 1.0, 8192, dev)
    before = mk.launch_counts()
    got = mk.trace_paths(tables, *rays, SEED, SKY, 8, kernel="cuda")
    counts = {k: v - before[k] for k, v in mk.launch_counts().items()}
    assert counts == dict(launches=1, winners_launches=0, noise_launches=1,
                          image_launches=1, sky_launches=1, raygen_launches=0,
                          retrace_launches=0, accum_launches=0)
    want = mk.trace_paths(tables, *rays, SEED, SKY, 8, kernel="torch")
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    diverged = ((got - want).abs() > 1e-3).float().mean().item()
    assert diverged < 0.005, diverged
    torch.testing.assert_close(got.mean(0), want.mean(0), rtol=0.02, atol=5e-3)


def test_compacted_bit_equal_on_card(dev):
    tables = mk.pack_scene(build_scene("final_scene", device=dev))
    rays = _rays("final_scene", 16 / 9, 2500, dev)
    bg = SCENE_DEFAULTS["final_scene"]["background"]
    full = mk.trace_paths(tables, *rays, SEED, bg, 9, kernel="cuda")
    comp, overflow = mk.trace_paths_compact(
        tables, mk.init_state(*rays), 2500, SEED, bg, 9,
        capacities=((1, 0.9), (3, 0.5), (6, 0.3)), kernel="cuda")
    assert not overflow.item()
    assert torch.equal(comp, full)


ACCUM_CASES = {   # scene: (aspect, capacities leaving most rows padding, overflowing)
    "final_scene": (16 / 9, ((1, 0.95), (3, 0.9), (6, 0.8)), ((1, 0.05),)),
    "cornell_box": (1.0, ((2, 0.95), (4, 0.9), (6, 0.85)), ((2, 0.1),)),
}


def _scatter_compact(tables, state, n, bg, depth, capacities):
    """trace_paths_compact's total from the kernel's radiance deltas
    (accum=None), scattered by a dense add before the first compaction and
    a per-channel index_add_ over every row, padding included, after it."""
    total = torch.zeros((3, state.shape[0]), device=state.device)
    count = torch.full((), n, dtype=torch.int64, device=state.device)
    overflow = torch.zeros((), dtype=torch.bool, device=state.device)
    for b0, n_b, out_cap in mk.schedule(n, depth, capacities):
        if out_cap < state.shape[0]:
            state, ovf = mk.compact(state, count, out_cap)
            overflow = overflow | ovf
        rad, state = mk.trace_segment(tables, state, SEED, bg, b0, n_b)
        if out_cap == total.shape[1]:
            total += rad
        else:
            rid = state[:, mk.S_RID].view(torch.int32).long()
            for c in range(3):
                total[c].index_add_(0, rid, rad[c])
        count = (state[:, mk.S_AL] > 0.5).sum()
    return total[:, :n].t(), overflow


@pytest.mark.parametrize("overflowing", [False, True], ids=["padding", "overflow"])
@pytest.mark.parametrize("name", sorted(ACCUM_CASES))
def test_accum_write_out_bit_equal_on_card(dev, name, overflowing):
    """trace_paths_compact adds each ray's radiance at its ray id in the
    kernel's write-out: bit-equal to the same segments' radiance deltas
    scattered by index_add_, under capacities that leave most rows padding
    (then also to the uncompacted trace) and under one that overflows.
    Every launch of the batch adds into the total; trace_paths' launch
    does not."""
    aspect, roomy, tight = ACCUM_CASES[name]
    caps = tight if overflowing else roomy
    tables = mk.pack_scene(build_scene(name, device=dev))
    rays = _rays(name, aspect, 4096, dev)
    bg = SCENE_DEFAULTS[name]["background"]
    state = mk.init_state(*rays)
    mk.reset_launch_counts()
    got, overflow = mk.trace_paths_compact(tables, state, 4096, SEED, bg, 8,
                                           capacities=caps, kernel="cuda")
    counts = mk.launch_counts()
    assert counts["accum_launches"] == counts["launches"] == len(mk.schedule(4096, 8, caps))
    want, want_ovf = _scatter_compact(tables, state, 4096, bg, 8, caps)
    assert overflow.item() == want_ovf.item() == overflowing
    assert torch.equal(got, want)
    mk.reset_launch_counts()
    full = mk.trace_paths(tables, *rays, SEED, bg, 8, kernel="cuda")
    assert mk.launch_counts()["launches"] == 1 and mk.launch_counts()["accum_launches"] == 0
    if not overflowing:
        assert torch.equal(got, full)


@pytest.mark.parametrize("name", sorted(ACCUM_CASES))
def test_accum_segment_adds_onto_the_total_on_card(dev, name):
    """One launch over a compacted buffer whose padding rows all repeat one
    ray id, onto a nonzero total: what index_add_ of the launch's radiance
    delta over every row adds, and the same carried state."""
    aspect = ACCUM_CASES[name][0]
    tables = mk.pack_scene(build_scene(name, device=dev))
    bg = SCENE_DEFAULTS[name]["background"]
    state = mk.init_state(*_rays(name, aspect, 8192, dev))
    _, state = mk.trace_segment(tables, state, SEED, bg, 0, 2)
    count = (state[:, mk.S_AL] > 0.5).sum()
    cap = mk._tiles(int(2.5 * count.item()))
    comp, _ = mk.compact(state, count, cap)
    pad = comp[count:, mk.S_RID].view(torch.int32)
    assert pad.numel() > 0 and (pad == pad[0]).all()
    base = torch.rand((3, state.shape[0]), generator=torch.Generator().manual_seed(1)).to(dev)
    rad, want_state = mk.trace_segment(tables, comp, SEED, bg, 2, 3)
    want = base.clone()
    rid = comp[:, mk.S_RID].view(torch.int32).long()
    for c in range(3):
        want[c].index_add_(0, rid, rad[c])
    got = base.clone()
    none, got_state = mk.trace_segment(tables, comp, SEED, bg, 2, 3, accum=got)
    assert none is None
    assert torch.equal(got_state, want_state)
    assert torch.equal(got, want) and not torch.equal(got, base)


def test_accum_rejects_what_the_kernel_does_not_take(dev):
    tables = mk.pack_scene(build_scene("cornell_box", device=dev))
    state = mk.init_state(*_rays("cornell_box", 1.0, 1024, dev))
    bg = (0.0, 0.0, 0.0)
    before = mk.launch_counts()["launches"]
    with pytest.raises(TypeError, match="float32"):
        mk.trace_segment(tables, state, SEED, bg, 0, 1,
                         accum=torch.zeros((3, 1024), dtype=torch.float64, device=dev))
    with pytest.raises(TypeError, match="contiguous"):
        mk.trace_segment(tables, state, SEED, bg, 0, 1,
                         accum=torch.zeros((1024, 3), device=dev).t())
    with pytest.raises(ValueError, match=r"\[3, cols\]"):
        mk.trace_segment(tables, state, SEED, bg, 0, 1, accum=torch.zeros((4, 1024), device=dev))
    with pytest.raises(ValueError, match="is on cpu"):
        mk.trace_segment(tables, state, SEED, bg, 0, 1, accum=torch.zeros((3, 1024)))
    assert mk.launch_counts()["launches"] == before


def test_wrapper_rejects_what_the_kernel_does_not_take(dev):
    tables = mk.pack_scene(build_scene("cornell_box", device=dev))
    state = mk.init_state(*_rays("cornell_box", 1.0, 1024, dev))
    bg = (0.0, 0.0, 0.0)
    before = mk.launch_counts()["launches"]
    with pytest.raises(ValueError, match="contiguous"):
        mk.trace_segment(tables, state.t().contiguous().t(), SEED, bg, 0, 1)
    with pytest.raises(TypeError, match="float32"):
        mk.trace_segment(tables, state.double(), SEED, bg, 0, 1)
    cpu_tables = mk.pack_scene(build_scene("cornell_box", device="cpu"))
    with pytest.raises(ValueError, match="is on cpu"):
        mk.trace_segment(cpu_tables, state, SEED, bg, 0, 1)
    with pytest.raises(ValueError, match="needs tensors on a CUDA device"):
        mk.trace_paths(cpu_tables, *_rays("cornell_box", 1.0, 64, "cpu"), SEED, bg, 2,
                       kernel="cuda")
    assert mk.launch_counts()["launches"] == before


def test_render_image_defaults_to_the_card(dev):
    before = mk.launch_counts()["launches"]
    img, accum = render_image(RenderConfig(scene="final_scene", width=64, height=36,
                                           samples_per_pixel=2, max_depth=12))
    assert accum.device.type == "cuda"
    assert img.shape == (36, 64, 3) and torch.isfinite(accum).all()
    assert mk.launch_counts()["launches"] > before


def _alive(fn, tables, state, bg, depth):
    """[depth, m] bool: alive entering each bounce, stepping fn one bounce
    at a time."""
    alive = []
    for b in range(depth):
        alive.append(state[:, mk.S_AL] > 0.5)
        _, state = fn(tables, state, SEED, bg, b, 1)
    return torch.stack(alive)


@pytest.mark.parametrize("name", ["final_scene", "cornell_box"])
def test_kernel_winners_vs_plain_on_card(dev, name):
    """Winners of the kernel's want_winners variant against the plain
    version's, on (bounce, ray) entries alive on both sides: at most 0.5%
    differ (a last-bit difference in a candidate t can flip a closest
    hit). Radiance and state are bit-equal to the radiance-only launch."""
    tables = mk.pack_scene(build_scene(name, device=dev))
    rays = _rays(name, 16 / 9 if name == "final_scene" else 1.0, 8192, dev)
    bg = SCENE_DEFAULTS[name]["background"]
    state = mk.init_state(*rays)
    before = mk.launch_counts()["winners_launches"]
    rad_w, st_w, win = mk.trace_segment(tables, state, SEED, bg, 0, 8, want_winners=True)
    assert mk.launch_counts()["winners_launches"] == before + 1
    rad, st = mk.trace_segment(tables, state, SEED, bg, 0, 8)
    _, _, want = mk.trace_segment_plain(tables, state, SEED, bg, 0, 8, want_winners=True)
    torch.cuda.synchronize()
    assert torch.equal(rad_w, rad) and torch.equal(st_w, st)
    assert win.shape == (8, state.shape[0]) and win.dtype == torch.int32
    assert (win >= -1).all() and (win < tables.s_pad + tables.r_pad).all()
    alive_k = _alive(mk.trace_segment, tables, state, bg, 8)
    alive_p = _alive(mk.trace_segment_plain, tables, state, bg, 8)
    assert (win[~alive_k] == -1).all()
    live = alive_k & alive_p
    differ = (win[live] != want[live]).float().mean().item()
    assert differ <= 0.005, differ


def test_train_step_on_card(dev):
    """A small streamed train step through the kernel: finite loss and
    parameters, albedo moved, one forward and one winners launch per
    block (two blocks)."""
    scene = build_scene("final_scene", device=dev)
    cam = camera_for_scene("final_scene", 16 / 9, dev)
    target = torch.full((18, 32, 3), 0.5, device=dev)
    before = mk.launch_counts()
    p1, loss = sharded_train_step(scene, cam, target, 32, 18, 2, 6,
                                  SCENE_DEFAULTS["final_scene"]["background"], 7, lr=1.0,
                                  rays_per_chunk=32 * 18)
    after = mk.launch_counts()
    assert after["launches"] - before["launches"] == 4
    assert after["winners_launches"] - before["winners_launches"] == 2
    assert torch.isfinite(loss) and loss.item() > 0.0
    p0 = extract_params(scene)
    for k, v in p1.items():
        assert v.device.type == "cuda" and torch.isfinite(v).all(), k
    assert (p0["color"] != p1["color"]).any()


def test_golden_train_step_on_card(dev):
    """A small train step on golden_scene under its own gradient sky:
    every launch is the sky variant, and the sky makes the sphere centers
    and radii move along with the albedo."""
    scene = build_scene("golden_scene", device=dev)
    cam = camera_for_scene("golden_scene", 1.5, dev)
    target = torch.full((16, 24, 3), 0.5, device=dev)
    before = mk.launch_counts()
    p1, loss = sharded_train_step(scene, cam, target, 24, 16, 2, 6,
                                  SCENE_DEFAULTS["golden_scene"]["background"], 7, lr=1.0)
    counts = {k: v - before[k] for k, v in mk.launch_counts().items()}
    assert counts["launches"] == 2 and counts["winners_launches"] == 1
    assert counts["sky_launches"] == 2
    assert torch.isfinite(loss) and loss.item() > 0.0
    p0 = extract_params(scene)
    for k, v in p1.items():
        assert v.device.type == "cuda" and torch.isfinite(v).all(), k
    for k in ("c0", "radius", "color"):
        assert (p0[k] != p1[k]).any(), k


def _every_group(tables, state, bg, b0, n_bounces):
    """(radiance, state, winners) of a launch at each G, asserted bit-equal
    across G; returns the G = 1 outputs."""
    ref = None
    for g in mk.GROUPS:
        out = mk.trace_segment(tables, state, SEED, bg, b0, n_bounces, want_winners=True,
                               _group=g)
        assert mk.trace_segment.last_shape[0] == g
        if ref is None:
            ref = out
            continue
        for what, a, b in zip(("radiance", "state", "winners"), ref, out):
            assert torch.equal(a, b), f"{what} at G={g} differs from G=1"
    return ref


@pytest.mark.parametrize("name", ["final_scene", "golden_scene"])
def test_every_lane_group_bit_equal_on_card(dev, name):
    """Every G (lanes a ray) gives the same radiance, state and winners bit
    for bit: at 65,536 camera rays, depth 8, and at the last render
    segment's shape (the survivors of 20 bounces compacted into 8,192
    lanes, 30 bounces from bounce 20). The launch the wrapper shapes
    itself gives them too, and the radiance-only launch the same radiance
    and state."""
    aspect = 16 / 9 if name == "final_scene" else 1.5
    tables = mk.pack_scene(build_scene(name, device=dev))
    bg = SCENE_DEFAULTS[name]["background"]
    state = mk.init_state(*_rays(name, aspect, 65536, dev))
    _, st20 = mk.trace_segment(tables, state, SEED, bg, 0, 20)
    small, overflow = mk.compact(st20, (st20[:, mk.S_AL] > 0.5).sum(), 8192)
    assert not overflow.item()
    for st, b0, n_b in ((state, 0, 8), (small, 20, 30)):
        ref = _every_group(tables, st, bg, b0, n_b)
        auto = mk.trace_segment(tables, st, SEED, bg, b0, n_b, want_winners=True)
        rad, out = mk.trace_segment(tables, st, SEED, bg, b0, n_b)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(ref, auto))
        assert torch.equal(rad, ref[0]) and torch.equal(out, ref[1])
    # G = 1 for the camera rays' full buffer, more lanes a ray for the small one
    mk.trace_segment(tables, small, SEED, bg, 20, 30)
    assert mk.trace_segment.last_shape[0] > 1


def test_ties_take_the_lower_index_on_card(dev):
    """Exact ties (a duplicated sphere, a duplicated rect) go to the lower
    index at every G, as in the plain version: the copies never win, and
    the winners agree with the plain version's on the entries alive on
    both sides."""
    scene = tie_scene(port_scene).build(dev)
    tables = mk.pack_scene(scene)
    bg = (0.7, 0.8, 1.0)
    state = mk.init_state(*_rays("two_perlin_spheres", 1.5, 8192, dev))
    rad, _, win = _every_group(tables, state, bg, 0, 6)
    _, _, want = mk.trace_segment_plain(tables, state, SEED, bg, 0, 6, want_winners=True)
    torch.cuda.synchronize()
    for lost, won in zip(TIE_LOSERS(tables.s_pad), TIE_WINNERS(tables.s_pad)):
        assert not (win == lost).any() and not (want == lost).any()
        assert (win[0] == won).sum() > 100   # the tied pair is in view
    alive_k = _alive(mk.trace_segment, tables, state, bg, 6)
    alive_p = _alive(mk.trace_segment_plain, tables, state, bg, 6)
    live = alive_k & alive_p
    assert torch.equal(win[0], want[0])
    differ = (win[live] != want[live]).float().mean().item()
    assert differ <= 0.005, differ
    assert torch.isfinite(rad).all()


def test_back_to_back_launches_reuse_the_counter_on_card(dev):
    """Two launches in a row on one stream (the next-ray counter zeroed and
    reused) give bit-equal outputs, and a launch on another stream too."""
    tables = mk.pack_scene(build_scene("final_scene", device=dev))
    bg = SCENE_DEFAULTS["final_scene"]["background"]
    state = mk.init_state(*_rays("final_scene", 16 / 9, 32768, dev))
    first = mk.trace_segment(tables, state, SEED, bg, 0, 5, want_winners=True)
    second = mk.trace_segment(tables, state, SEED, bg, 0, 5, want_winners=True)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        third = mk.trace_segment(tables, state, SEED, bg, 0, 5, want_winners=True)
    torch.cuda.synchronize()
    for a, b, c in zip(first, second, third):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.parametrize("rows", [1024, 100])
def test_small_buffers_on_card(dev, rows):
    """m = 1024 lanes, and m = 100, whose lanes even at 32 a ray are far
    fewer than the persistent grid's threads: the wrapper takes 32 lanes a
    ray and no more blocks than those lanes fill; every G gives the rows
    of the 1024-lane launch bit for bit (each output depends only on its
    own ray); and the 1024 lanes hold the kernel bars against the plain
    version."""
    tables = mk.pack_scene(build_scene("final_scene", device=dev))
    bg = SCENE_DEFAULTS["final_scene"]["background"]
    full = mk.init_state(*_rays("final_scene", 16 / 9, 1024, dev))
    rad_full, st_full = mk.trace_segment(tables, full, SEED, bg, 0, 8)
    state = full[:rows].contiguous()
    rad, st, _ = _every_group(tables, state, bg, 0, 8)
    mk.trace_segment(tables, state, SEED, bg, 0, 8)
    g, blocks = mk.trace_segment.last_shape
    assert g == 32 and blocks == -(-rows * 32 // mk.BLOCK)
    want, _ = mk.trace_segment_plain(tables, full, SEED, bg, 0, 8)
    torch.cuda.synchronize()
    assert torch.equal(rad, rad_full[:, :rows]) and torch.equal(st, st_full[:rows])
    diverged = ((rad_full - want).abs() > 1e-3).float().mean().item()
    assert diverged < 0.005, diverged
    torch.testing.assert_close(rad_full.mean(1), want.mean(1), rtol=0.02, atol=0.0)


@pytest.mark.parametrize("name", ["final_scene", "cornell_box", "two_perlin_spheres"])
def test_eager_vs_plain_on_card(dev, name):
    """The eager integrator on the card against the plain bounce version on
    the card (no kernel launch). Their closest-hit sums round differently
    (cuBLAS's FMA chains against the plain version's column order), which
    flips a rare path on final_scene's glass and r=1000 ground (0.51% of
    all lanes past 1e-3 at this size, at the lane bar itself). So: at most
    1% of the rays take other winners (tests/test_torch_sky_train.py's
    bar); on the rays whose winners agree, the lane bar (a Schlick draw
    can still flip where both branches leave the scene, and the noise
    texture amplifies last bits: 0.05% of their lanes measured); channel
    means within 2%."""
    aspect, _, atol = KERNEL_CASES[name]
    scene = build_scene(name, device=dev)
    rays = _rays(name, aspect, 8192, dev)
    bg = SCENE_DEFAULTS[name]["background"]
    before = mk.launch_counts()["launches"]
    got = integrator.trace_paths(scene, *rays, SEED, bg, 8)
    _, e_win = integrator.path_decisions(scene, *rays, SEED, 8)
    assert mk.launch_counts()["launches"] == before and got.device.type == "cuda"
    tables = mk.pack_scene(scene)
    want, p_win = mk.trace_paths(tables, *rays, SEED, bg, 8, kernel="torch",
                                 return_winners=True)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    same = (e_win == p_win).all(0)
    assert 1.0 - same.float().mean().item() <= 0.01
    off = ((got[same] - want[same]).abs() > 1e-3).float().mean().item()
    assert off <= 0.005, off
    torch.testing.assert_close(got.mean(0), want.mean(0), rtol=0.02, atol=atol)


def test_float64_on_card(dev):
    """float64 renders on the card through the eager integrator, with no
    downcast, and agrees with the same render on the CPU; the float32
    kernel refuses a float64 scene."""
    cfg = RenderConfig(scene="cornell_box", width=16, height=16, samples_per_pixel=4,
                       max_depth=5, dtype="float64")
    before = mk.launch_counts()["launches"]
    _, got = render_image(cfg)
    assert got.device.type == "cuda" and got.dtype == torch.float64
    assert mk.launch_counts()["launches"] == before
    _, want = render_image(cfg, device="cpu")
    off = ((got.cpu() - want).abs() > 1e-6).double().mean().item()
    assert off <= 0.005, off
    with pytest.raises(ValueError, match="float32 only"):
        render_image(cfg, kernel="cuda")


def test_resume_matches_uninterrupted_on_card(dev, tmp_path):
    scene = build_scene("two_spheres", device=dev)
    cam = camera_for_scene("two_spheres", 1.0, dev)
    bg = SCENE_DEFAULTS["two_spheres"]["background"]
    kw = dict(rays_per_chunk=16 * 16 * 2)
    full = render_mod.render(scene, cam, 16, 16, 8, 3, bg, SEED, **kw)
    partial = render_mod.render(scene, cam, 16, 16, 4, 3, bg, SEED, **kw)
    p = str(tmp_path / "r.ckpt")
    checkpoint.save(p, checkpoint.RenderState(
        partial.cpu().numpy(), 4, checkpoint._meta("two_spheres", 16, 16, 8, 3, SEED)))
    before = mk.launch_counts()["launches"]
    resumed = checkpoint.render_resumable(scene, cam, "two_spheres", 16, 16, 8, 3, bg, SEED,
                                          p, **kw)
    assert mk.launch_counts()["launches"] > before and resumed.device.type == "cuda"
    torch.testing.assert_close(resumed, full, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["final_scene", "cornell_box"])
def test_adaptive_schedule_bit_equal_on_card(dev, name):
    """Compaction is exact and every ray adds its radiance once, so the
    adaptive schedule's framebuffer is bit-equal to the static one's."""
    p = SCENE_DEFAULTS[name]
    cfg = RenderConfig(scene=name, width=96, height=64, samples_per_pixel=4, max_depth=30)
    caps = render_mod.adaptive_capacities(name, p["background"], 30)
    assert caps != render_mod._capacities_for(p["background"])
    _, adaptive = render_image(cfg)
    _, static = render_image(cfg, capacities=render_mod._capacities_for(p["background"]))
    assert torch.equal(adaptive, static)


# Ray generation on the card (raygen_kernel through megakernel.ray_state):
# (scene, width, height, samples a pixel, first sample, pixel range, seed).
# A full final_scene 1-spp batch and a full golden_scene 4-spp batch (the
# benchmark's batch shapes), then ranges that start past pixel 0, samples
# past 0 and ray counts that are not a TILE multiple.
RAYGEN_CASES = [
    ("final_scene", 1200, 675, 1, 0, None, SEED),
    ("final_scene", 64, 36, 4, 8, (100, 1901), 3_000_000_000),
    ("golden_scene", 600, 400, 4, 0, None, SEED),
    ("golden_scene", 60, 40, 1, 37, (13, 2000), 2**32 - 1),
]


@pytest.mark.parametrize("case", RAYGEN_CASES, ids=lambda c: f"{c[0]}-{c[3]}spp-{c[4]}")
def test_raygen_kernel_bit_equal_on_card(dev, case):
    """The kernel's state is bit for bit what generate_rays + init_state
    compute with PyTorch's CUDA ops (signed zeros included)."""
    name, w, h, spp, start, pixels, seed = case
    cam = camera_for_scene(name, w / h, dev)
    kw = dict(width=w, height=h, n_samples=spp, pixels=pixels)
    before = mk.launch_counts()["raygen_launches"]
    got = mk.ray_state(cam, seed, start, **kw)
    assert mk.launch_counts()["raygen_launches"] == before + 1
    want = mk.init_state(*batch_rays(cam, seed, start, **kw))
    assert got.shape == want.shape
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _twin_state(camera, seed, sample_start, host_camera=None, kernel=None, **kw):
    return mk.init_state(*batch_rays(camera, seed, sample_start, **kw))


@pytest.mark.parametrize("name,w,h,spp", [("final_scene", 96, 54, 16),
                                          ("golden_scene", 60, 40, 4)])
def test_render_image_same_bits_as_the_twin_on_card(dev, monkeypatch, name, w, h, spp):
    """render_image's accum is bit-equal with the kernel's states and with
    the PyTorch ops' (the twin forced), and the kernel runs once a batch."""
    cfg = RenderConfig(scene=name, width=w, height=h, samples_per_pixel=spp,
                       rays_per_chunk=w * h * 2)   # 2 samples a batch
    mk.reset_launch_counts()
    _, got = render_image(cfg)
    assert mk.launch_counts()["raygen_launches"] == spp // 2
    monkeypatch.setattr(render_mod, "ray_state", _twin_state)
    _, want = render_image(cfg)
    assert torch.equal(got, want)


def test_ray_state_is_float32_only_on_card(dev):
    """raygen_kernel is float32 only: a float64 camera on the card raises
    rather than falling back to the PyTorch ops."""
    cam = camera_for_scene("final_scene", 16 / 9, dev, torch.float64)
    with pytest.raises(ValueError, match="float32"):
        mk.ray_state(cam, SEED, 0, width=16, height=9, n_samples=1)


def test_plain_render_launches_no_raygen_on_card(dev):
    """kernel="torch" is the plain version throughout: its batches make
    their rays with the PyTorch ops, and bit-equal to the kernel's."""
    cfg = RenderConfig(scene="final_scene", width=32, height=18, samples_per_pixel=2,
                       max_depth=6)
    mk.reset_launch_counts()
    render_image(cfg, kernel="torch")
    assert mk.launch_counts()["raygen_launches"] == 0
    cam = camera_for_scene("final_scene", 32 / 18, dev)
    kw = dict(width=32, height=18, n_samples=2)
    plain = mk.ray_state(cam, SEED, 0, kernel="torch", **kw)
    assert mk.launch_counts()["raygen_launches"] == 0
    assert torch.equal(plain.view(torch.int32), mk.ray_state(cam, SEED, 0, **kw).view(torch.int32))


def test_tracer_batch_never_syncs_on_card(dev):
    """A compacted render batch on the card never waits on the device: no
    synchronising call under torch.cuda.set_sync_debug_mode("error")."""
    scene = build_scene("final_scene", device=dev)
    cam = camera_for_scene("final_scene", 1200 / 675, dev)
    bg = SCENE_DEFAULTS["final_scene"]["background"]
    tracer = render_mod._Tracer(scene, cam, 1200, 675, 50, bg, SEED, "cuda", mk.CAPS_OPEN)
    sums = torch.zeros((1200 * 675, 3), device=dev)
    sums = tracer.batch(0, 1, sums)   # the first: builds and loads the library
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        sums = tracer.batch(1, 1, sums)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(tracer.recover(sums)).all()


def test_overflow_recovery_from_the_same_state_on_card(dev):
    """An overflowed batch is traced again from a state the kernel makes
    anew, bit-equal to the first: one more launch, and the recovered frame
    is the uncompacted one."""
    scene = build_scene("cornell_box", device=dev)
    cam = camera_for_scene("cornell_box", 1.0, dev)
    bg = (0.0, 0.0, 0.0)
    mk.reset_launch_counts()
    # 4,096 rays in one batch; entering bounce 2 the buffer holds 1,024
    fb = render_mod.render(scene, cam, 32, 32, 4, 6, bg, SEED, capacities=((2, 0.1),))
    assert mk.launch_counts()["raygen_launches"] == 2   # the batch, its re-trace
    want = render_mod.render(scene, cam, 32, 32, 4, 6, bg, SEED, capacities=())
    torch.testing.assert_close(fb, want, rtol=1e-5, atol=1e-6)


def test_cornell_frame_on_card(dev):
    """A Cornell frame (rects only, an area light, black background) on the
    kernel path: the bounce kernel runs, no batch overflows its adaptive
    schedule (0 re-traces), and the frame agrees with the plain version's
    under this file's bars, per pixel: at most 0.5% of pixel channels off
    by more than 1e-3 in mean radiance, channel means within 2%."""
    cfg = RenderConfig(scene="cornell_box", width=64, height=64, samples_per_pixel=8,
                       max_depth=50)
    mk.reset_launch_counts()
    _, got = render_image(cfg)
    counts = mk.launch_counts()
    assert counts["launches"] > 0
    assert counts["retrace_launches"] == 0
    _, want = render_image(cfg, kernel="torch")
    got, want = got / 8, want / 8
    assert torch.isfinite(got).all()
    diverged = ((got - want).abs() > 1e-3).float().mean().item()
    assert diverged < 0.005, diverged
    torch.testing.assert_close(got.mean((0, 1)), want.mean((0, 1)), rtol=0.02, atol=0.0)
