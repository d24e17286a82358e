"""float64 in rtweekend_tpu_torch (tests/test_f64.py on the port): the
dtype reaches every stage with no silent downcast, the port's float64
render agrees with the JAX package's float64 render, and the float32
render agrees with the float64 oracle within single-precision error.

float64 runs on the eager integrator only: "auto" picks it, and the
float32 bounce kernel and its plain version refuse a float64 scene. The
JAX side runs its jnp path (use_pallas=False) under jax_enable_x64, as
tests/test_f64.py does. In float64 a multiply-add contracted into an FMA
by XLA moves a result by ~1e-16, so at most 0.5% of the framebuffer
entries may differ by more than 1e-6 (a flipped discrete decision)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtweekend_tpu.config import SCENE_DEFAULTS
from rtweekend_tpu.models.builders import build_scene as jax_build_scene
from rtweekend_tpu.render import camera_for_scene as jax_camera_for_scene
from rtweekend_tpu.render import render as jax_render
from rtweekend_tpu_torch.config import RenderConfig
from rtweekend_tpu_torch.convert import scene_from_numpy
from rtweekend_tpu_torch.models.builders import build_scene
from rtweekend_tpu_torch.ops import integrator
from rtweekend_tpu_torch.ops.camera import batch_rays
from rtweekend_tpu_torch.ops.cuda import megakernel as mk
from rtweekend_tpu_torch.render import camera_for_scene, render, render_image

from test_torch_megakernel import one_torch_thread  # noqa: F401  (autouse)
from test_torch_scene import assert_leaves_equal, jax_leaves, scene_to_numpy

W = H = 16
SPP, DEPTH, SEED = 4, 5, 42


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _port_render(name, dtype, kernel="auto"):
    scene = build_scene(name, seed=SEED, device="cpu", dtype=dtype)
    cam = camera_for_scene(name, 1.0, "cpu", dtype)
    return render(scene, cam, W, H, SPP, DEPTH, SCENE_DEFAULTS[name]["background"], SEED,
                  kernel=kernel)


def test_f64_dtype_end_to_end():
    dt = torch.float64
    scene = build_scene("cornell_box", device="cpu", dtype=dt)
    floats = [v for v in scene_to_numpy(scene).values() if v.dtype.kind == "f"]
    assert floats and all(v.dtype == np.float64 for v in floats)
    cam = camera_for_scene("cornell_box", 1.0, "cpu", dt)
    assert all(getattr(cam, k).dtype == dt for k in ("origin", "horizontal", "lens_radius"))
    o, d, t, pid, sid = batch_rays(cam, SEED, 0, width=W, height=H, n_samples=SPP)
    assert o.dtype == d.dtype == t.dtype == dt
    rad = integrator.trace_paths(scene, o, d, t, pid, sid, SEED, (0.0, 0.0, 0.0), DEPTH)
    assert rad.dtype == dt
    img, accum = render_image(RenderConfig(scene="cornell_box", width=W, height=H,
                                           samples_per_pixel=SPP, max_depth=DEPTH,
                                           dtype="float64"), device="cpu")
    assert accum.dtype == dt and img.dtype == np.uint8
    assert torch.isfinite(accum).all() and accum.max() > 0.0


def test_f64_refuses_the_float32_kernel():
    for kernel in ("cuda", "torch"):
        with pytest.raises(ValueError, match="float32 only"):
            _port_render("cornell_box", torch.float64, kernel)
    with pytest.raises(TypeError, match="float32 only"):
        mk.pack_scene(build_scene("cornell_box", device="cpu", dtype=torch.float64))


def test_f64_scene_and_leaves_match_jax(x64):
    """The float64 build equals the JAX float64 build leaf for leaf, and
    convert.scene_from_numpy carries JAX's float64 leaves as they are."""
    want = jax_leaves(jax_build_scene("final_scene", dtype=jnp.float64))
    assert_leaves_equal(scene_to_numpy(build_scene("final_scene", device="cpu",
                                                   dtype=torch.float64)), want)
    assert_leaves_equal(scene_to_numpy(scene_from_numpy(want, device="cpu")), want)
    mixed = dict(want, **{"spheres.c0": want["spheres.c0"].astype(np.float32)})
    with pytest.raises(TypeError, match="all float32 or all float64"):
        scene_from_numpy(mixed, device="cpu")


@pytest.mark.parametrize("name", ["cornell_box", "final_scene"])
def test_f64_render_matches_jax_f64(name, x64):
    scene = jax_build_scene(name, seed=SEED, dtype=jnp.float64)
    cam = jax_camera_for_scene(name, dtype=jnp.float64, aspect_ratio=1.0)
    want = np.asarray(jax_render(scene, cam, W, H, SPP, DEPTH,
                                 SCENE_DEFAULTS[name]["background"], SEED,
                                 dtype=jnp.float64, use_pallas=False))
    assert want.dtype == np.float64
    got = _port_render(name, torch.float64).numpy()
    assert got.dtype == np.float64
    off = np.abs(got - want) > 1e-6
    assert off.mean() <= 0.005, off.mean()
    np.testing.assert_allclose(got.mean((0, 1)), want.mean((0, 1)), rtol=0.02)


def test_f32_matches_port_f64_oracle():
    """tests/test_f64.py:48-58's bars on the port: at most 2% of entries
    off by more than 1e-3, means within 5e-3."""
    f64 = _port_render("cornell_box", torch.float64).numpy()
    f32 = _port_render("cornell_box", torch.float32, "eager").numpy().astype(np.float64)
    diff = np.abs(f32 - f64)
    assert (diff > 1e-3).mean() < 0.02, (diff > 1e-3).mean()
    np.testing.assert_allclose(f32.mean(), f64.mean(), rtol=5e-3)
