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
