"""Card-only tests of rtweekend_tpu_torch's CUDA bounce kernel.

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

from rtweekend_tpu_torch.config import SCENE_DEFAULTS, RenderConfig
from rtweekend_tpu_torch.models import scene as port_scene
from rtweekend_tpu_torch.models.builders import _procedural_earth_rgba, build_scene
from rtweekend_tpu_torch.ops.camera import generate_rays
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
                          image_launches=1, sky_launches=1)
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
        tables, *rays, SEED, bg, 9, capacities=((1, 0.9), (3, 0.5), (6, 0.3)),
        kernel="cuda")
    assert not overflow.item()
    assert torch.equal(comp, full)


def test_wrapper_rejects_what_the_kernel_does_not_take(dev):
    tables = mk.pack_scene(build_scene("cornell_box", device=dev))
    state = mk.init_state(*_rays("cornell_box", 1.0, 1024, dev))
    bg = (0.0, 0.0, 0.0)
    before = mk.trace_segment.launches
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
    assert mk.trace_segment.launches == before


def test_render_image_defaults_to_the_card(dev):
    before = mk.trace_segment.launches
    img, accum = render_image(RenderConfig(scene="final_scene", width=64, height=36,
                                           samples_per_pixel=2, max_depth=12))
    assert accum.device.type == "cuda"
    assert img.shape == (36, 64, 3) and torch.isfinite(accum).all()
    assert mk.trace_segment.launches > before


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
    before = mk.trace_segment.winners_launches
    rad_w, st_w, win = mk.trace_segment(tables, state, SEED, bg, 0, 8, want_winners=True)
    assert mk.trace_segment.winners_launches == before + 1
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
    launches, winners = mk.trace_segment.launches, mk.trace_segment.winners_launches
    p1, loss = sharded_train_step(scene, cam, target, 32, 18, 2, 6,
                                  SCENE_DEFAULTS["final_scene"]["background"], 7, lr=1.0,
                                  rays_per_chunk=32 * 18)
    assert mk.trace_segment.launches - launches == 4
    assert mk.trace_segment.winners_launches - winners == 2
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
