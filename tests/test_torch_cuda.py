"""Card-only tests of rtweekend_tpu_torch's CUDA bounce kernel.

They skip without a CUDA device. The file imports no JAX, so on the
card it runs without the suite's JAX set-up in tests/conftest.py:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

The kernel and the plain version sum the 17-term coefficient dots with
and without fused multiply-adds, which can flip a discrete decision on a
rare ray (tests/test_pallas.py's final_scene bars apply): at most 0.5%
of lanes off by more than 1e-3, channel means within 2%.
"""

import numpy as np
import pytest
import torch

from rtweekend_tpu_torch.config import SCENE_DEFAULTS, RenderConfig
from rtweekend_tpu_torch.models.builders import build_scene
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


@pytest.mark.parametrize("name", ["final_scene", "cornell_box"])
def test_kernel_vs_plain_on_card(dev, name):
    tables = mk.pack_scene(build_scene(name, device=dev))
    rays = _rays(name, 16 / 9 if name == "final_scene" else 1.0, 8192, dev)
    bg = SCENE_DEFAULTS[name]["background"]
    before = mk.trace_segment.launches
    got = mk.trace_paths(tables, *rays, SEED, bg, 8, kernel="cuda")
    assert mk.trace_segment.launches == before + 1
    want = mk.trace_paths(tables, *rays, SEED, bg, 8, kernel="torch")
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    diverged = ((got - want).abs() > 1e-3).float().mean().item()
    assert diverged < 0.005, diverged
    torch.testing.assert_close(got.mean(0), want.mean(0), rtol=0.02, atol=0.0)


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
