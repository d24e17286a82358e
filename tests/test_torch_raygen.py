"""A render batch's initial ray state (ops/cuda/megakernel.ray_state) on
the CPU.

On the card ray_state launches raygen_kernel (csrc/megakernel.cu), held
bit for bit against the PyTorch ops there (tests/test_torch_cuda.py).
Here it takes those ops themselves, init_state(*batch_rays(...)): held
against them and, word for word, against the JAX package's
`_init_state` of its `generate_rays`. The integer words (pixel, sample,
alive, the dead padding) are equal; the floats are compared at
tests/test_torch_rng.py's camera tolerance, since XLA and PyTorch round
sin, cos and fused products each in their own way.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtweekend_tpu.ops.camera import generate_rays as jax_generate_rays
from rtweekend_tpu.ops.pallas import megakernel as jmk
from rtweekend_tpu.render import camera_for_scene as jax_camera_for_scene
from rtweekend_tpu_torch import render as render_mod
from rtweekend_tpu_torch.config import SCENE_DEFAULTS, RenderConfig
from rtweekend_tpu_torch.ops.camera import batch_rays
from rtweekend_tpu_torch.ops.cuda import megakernel as mk

from test_torch_megakernel import one_torch_thread  # noqa: F401  (autouse)
from test_torch_rng import CAM_ATOL

SEED = 42
# (scene, width, height, samples a pixel, first sample, pixel range, seed):
# the card tests' shapes at a CPU test's size: whole images at 1 and 4
# samples a pixel, ranges past pixel 0, samples past 0, ray counts that
# are not a TILE multiple, seeds above 2^31
CASES = [
    ("final_scene", 48, 27, 1, 0, None, SEED),
    ("final_scene", 64, 36, 4, 8, (100, 701), 3_000_000_000),
    ("golden_scene", 30, 20, 4, 0, None, SEED),
    ("golden_scene", 60, 40, 1, 37, (13, 1100), 2**32 - 1),
]
IDS = [f"{c[0]}-{c[3]}spp-{c[4]}" for c in CASES]


def _kw(case):
    _, w, h, spp, _, pixels, _ = case
    return dict(width=w, height=h, n_samples=spp, pixels=pixels)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_ray_state_is_the_ops_state(case):
    name, w, h, _, start, _, seed = case
    cam = render_mod.camera_for_scene(name, w / h, "cpu")
    got = mk.ray_state(cam, seed, start, **_kw(case))
    want = mk.init_state(*batch_rays(cam, seed, start, **_kw(case)))
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_ray_state_matches_jax_init_state(case):
    name, w, h, spp, start, pixels, seed = case
    p0, p1 = (0, w * h) if pixels is None else pixels
    n = (p1 - p0) * spp
    cam = render_mod.camera_for_scene(name, w / h, "cpu")
    st = mk.ray_state(cam, seed, start, **_kw(case))
    assert st.shape == (-(-n // mk.TILE) * mk.TILE, len(mk.STATE_FIELDS))

    pid = np.repeat(np.arange(p0, p1, dtype=np.int32), spp)
    sid = np.tile(start + np.arange(spp, dtype=np.int32), p1 - p0)
    jcam = jax_camera_for_scene(name, aspect_ratio=w / h)
    o, d, t = jax_generate_rays(jcam, w, h, jnp.asarray(pid), jnp.asarray(sid),
                                jnp.uint32(seed))
    want = jmk._init_state(o, d, t, jnp.asarray(pid), jnp.asarray(sid))
    for k, field in enumerate(mk.STATE_FIELDS[:-1]):
        col = st[:, k]
        if field in ("pid", "sid"):
            np.testing.assert_array_equal(col.view(torch.int32).numpy(),
                                          np.asarray(want[field]))
        elif field in ("tr", "tg", "tb", "al"):
            np.testing.assert_array_equal(col.numpy(), np.asarray(want[field]))
        else:
            np.testing.assert_allclose(col.numpy(), np.asarray(want[field]),
                                       rtol=1e-6, atol=CAM_ATOL)
    # the dead padding, word for word; ray_id is the row
    np.testing.assert_array_equal(st[n:, :mk.S_RID].numpy(),
                                  np.asarray(jnp.stack([want[f] for f in mk.STATE_FIELDS[:-1]],
                                                       axis=1))[n:])
    np.testing.assert_array_equal(st[:, mk.S_RID].view(torch.int32).numpy(),
                                  np.arange(st.shape[0]))


def test_state_rays_give_back_the_state():
    """recover traces an overflowed batch uncompacted from the columns of
    its state: init_state of them is the state again."""
    case = CASES[1]
    cam = render_mod.camera_for_scene(case[0], case[1] / case[2], "cpu")
    st = mk.ray_state(cam, case[6], case[4], **_kw(case))
    n = (701 - 100) * 4
    again = mk.init_state(*mk.state_rays(st, n))
    assert torch.equal(again.view(torch.int32), st.view(torch.int32))


def test_camera_floats_in_kernel_order():
    """The 21 floats in the order rtw_raygen reads them (csrc/megakernel.cu):
    six vectors, then the lens radius and the shutter times."""
    cam = render_mod.camera_for_scene("final_scene", 16 / 9, "cpu")
    got = np.asarray(mk.camera_floats(cam), np.float32)
    vecs = (cam.origin, cam.horizontal, cam.vertical, cam.lower_left, cam.u, cam.v)
    for q, v in enumerate(vecs):
        np.testing.assert_array_equal(got[3 * q:3 * q + 3], v.numpy())
    np.testing.assert_array_equal(got[18:], [cam.lens_radius.item(), cam.time0.item(),
                                             cam.time1.item()])


@pytest.mark.parametrize("kernel", ["auto", "torch"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ray_state_takes_the_ops_on_the_cpu(kernel, dtype):
    """On the CPU every kernel choice but "cuda" takes the PyTorch ops, in
    the camera's dtype (the state itself is float32)."""
    cam = render_mod.camera_for_scene("final_scene", 16 / 9, "cpu", dtype)
    kw = dict(width=16, height=9, n_samples=2)
    got = mk.ray_state(cam, SEED, 3, kernel=kernel, **kw)
    want = mk.init_state(*batch_rays(cam, SEED, 3, **kw))
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("kernel", ["cuda", "pallas"])
def test_ray_state_refuses_a_kernel_it_cannot_run(kernel):
    """"cuda" needs the card, as for the bounce kernel; an unknown choice
    raises too."""
    cam = render_mod.camera_for_scene("final_scene", 16 / 9, "cpu")
    with pytest.raises(ValueError, match="kernel"):
        mk.ray_state(cam, SEED, 0, width=16, height=9, n_samples=1, kernel=kernel)


@pytest.mark.parametrize("spp", [1, 4])
def test_no_raygen_launch_on_the_cpu(spp):
    """The CPU takes the PyTorch ops: the kernel's counter stays 0, and
    the render is the one the ops give batch by batch (render_range over
    one sample at a time)."""
    cfg = RenderConfig(scene="final_scene", width=16, height=9, samples_per_pixel=spp,
                       max_depth=6, rays_per_chunk=16 * 9)
    mk.reset_launch_counts()
    _, accum = render_mod.render_image(cfg, device="cpu", capacities=mk.CAPS_OPEN)
    assert mk.launch_counts()["raygen_launches"] == 0
    scene = render_mod.build_scene("final_scene", device="cpu")
    cam = render_mod.camera_for_scene("final_scene", 16 / 9, "cpu")
    sums = torch.zeros(16 * 9, 3)
    for s in range(spp):
        sums += render_mod.render_range(scene, cam, 16, 9, (0, 16 * 9), (s, s + 1), 6,
                                        SCENE_DEFAULTS["final_scene"]["background"], 42,
                                        capacities=mk.CAPS_OPEN)
    assert mk.launch_counts()["raygen_launches"] == 0
    assert torch.equal(accum, render_mod.to_framebuffer(sums, 16, 9))
