"""rtweekend_tpu_torch RNG, vector math and camera against rtweekend_tpu.

Counter-RNG words must be bit-equal (the compaction and kernel parity
arguments rest on it), including counters above 2^31. Camera rays are
compared to f32 rounding: both sides evaluate the same formulas, but
XLA and PyTorch round sin/cos and fused products in their own way."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtweekend_tpu.ops.camera import generate_rays as jax_generate_rays
from rtweekend_tpu.render import camera_for_scene as jax_camera_for_scene
from rtweekend_tpu.utils import rng as jax_rng
from rtweekend_tpu.utils import vecmath as jax_vecmath
from rtweekend_tpu_torch.render import camera_for_scene
from rtweekend_tpu_torch.ops.camera import generate_rays
from rtweekend_tpu_torch.utils import rng, vecmath

# f32 rounding of the camera: a few ulp of the largest coordinate (~13)
CAM_ATOL = 4e-6

_r = np.random.default_rng(7)
IDS_A = _r.integers(-(2**31), 2**31, 512, dtype=np.int64).astype(np.int32)
IDS_B = _r.integers(-(2**31), 2**31, 512, dtype=np.int64).astype(np.int32)


@pytest.mark.parametrize("stream", [
    0, 7, rng.BOUNCE_STREAM0 + 99, rng.STREAM_CAMERA0, rng.STREAM_CAMERA1, 0xFFFFFFFF,
])
@pytest.mark.parametrize("seed", [0, 42, 0xDEADBEEF])
def test_pcg4d_and_uniform4_bit_equal(stream, seed):
    want = jax_rng.pcg4d(jnp.asarray(IDS_A), jnp.asarray(IDS_B), stream, seed)
    got = rng.pcg4d(torch.from_numpy(IDS_A), torch.from_numpy(IDS_B), stream, seed)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(np.int64))
    u_want = np.asarray(jax_rng.uniform4(seed, jnp.asarray(IDS_A), jnp.asarray(IDS_B), stream))
    u_got = rng.uniform4(seed, torch.from_numpy(IDS_A), torch.from_numpy(IDS_B), stream)
    np.testing.assert_array_equal(u_got.numpy(), u_want)


def test_vecmath_matches_jax():
    r = np.random.default_rng(3)
    u = r.normal(size=(64, 3)).astype(np.float32)
    v = r.normal(size=(64, 3)).astype(np.float32)
    u[0] = 0.0  # normalized()'s zero guard
    eta = r.uniform(0.5, 1.5, size=64).astype(np.float32)
    tu, tv = torch.from_numpy(u), torch.from_numpy(v)
    ju, jv = jnp.asarray(u), jnp.asarray(v)
    pairs = [
        (vecmath.dot(tu, tv), jax_vecmath.dot(ju, jv)),
        (vecmath.cross(tu, tv), jax_vecmath.cross(ju, jv)),
        (vecmath.normalized(tu), jax_vecmath.normalized(ju)),
        (vecmath.reflect(tu, tv), jax_vecmath.reflect(ju, jv)),
        (vecmath.refract(vecmath.normalized(tu), vecmath.normalized(tv), torch.from_numpy(eta)),
         jax_vecmath.refract(jax_vecmath.normalized(ju), jax_vecmath.normalized(jv),
                             jnp.asarray(eta))),
    ]
    for got, want in pairs:
        # elementwise f32 formulas; XLA may fuse a multiply-add
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    assert vecmath.near_zero(torch.zeros(1, 3)).item()


def test_camera_rays_final_scene():
    w, h, spp = 64, 36, 2
    n = w * h * spp
    pid = np.arange(n, dtype=np.int32) % (w * h)
    sid = np.arange(n, dtype=np.int32) // (w * h)
    jcam = jax_camera_for_scene("final_scene", aspect_ratio=16 / 9)
    tcam = camera_for_scene("final_scene", 16 / 9, device="cpu")
    for f in ("origin", "horizontal", "vertical", "lower_left", "u", "v", "w",
              "lens_radius", "time0", "time1"):
        np.testing.assert_array_equal(getattr(tcam, f).numpy(), np.asarray(getattr(jcam, f)))
    want = jax_generate_rays(jcam, w, h, jnp.asarray(pid), jnp.asarray(sid), jnp.uint32(42))
    got = generate_rays(tcam, w, h, torch.from_numpy(pid), torch.from_numpy(sid), 42)
    for g, wv in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wv), rtol=1e-6, atol=CAM_ATOL)
