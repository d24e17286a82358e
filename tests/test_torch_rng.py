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

from test_torch_megakernel import one_torch_thread  # noqa: F401  (autouse)

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


@pytest.mark.parametrize("stream", [rng.BOUNCE_STREAM0, rng.BOUNCE_STREAM0 + 7])
def test_gauss_unit_vector_in_unit_sphere_match_jax(stream):
    """Box-Muller and the unit vector are elementwise f32 formulas on
    bit-equal uniforms: rtol 1e-6 / atol 1e-6 (log1p, sin and cos may
    round differently by an ulp)."""
    a, b = torch.from_numpy(IDS_A), torch.from_numpy(IDS_B)
    ja, jb = jnp.asarray(IDS_A), jnp.asarray(IDS_B)
    u = rng.uniform4(42, a, b, stream)
    ju = jax_rng.uniform4(42, ja, jb, stream)
    np.testing.assert_allclose(rng.gauss4_from_u4(u).numpy(),
                               np.asarray(jax_rng.gauss4_from_u4(ju, jnp.dtype(jnp.float32))),
                               rtol=1e-6, atol=1e-6)
    uv = rng.unit_vector(42, a, b, stream)
    np.testing.assert_allclose(uv.numpy(), np.asarray(jax_rng.unit_vector(42, ja, jb, stream)),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(torch.linalg.norm(uv, dim=-1).numpy(), 1.0, rtol=1e-6)
    rad_u = u[:, 3]
    np.testing.assert_allclose(
        rng.in_unit_sphere(42, a, b, stream, rad_u).numpy(),
        np.asarray(jax_rng.in_unit_sphere(42, ja, jb, stream, jnp.asarray(rad_u.numpy()))),
        rtol=2e-6, atol=1e-6)


def test_cbrt_ulp_gap_to_jnp_cbrt():
    """PyTorch has no cbrt; u ** (1/3) against jnp.cbrt on 2^16 grid
    points of [0, 1) plus the uniforms' extremes, measured: 64,582 equal,
    955 one ulp apart, and 3 ulp at u = 2^-24, where u ** (1/3) is the
    correctly rounded cube root and jnp.cbrt is 3 ulp off it. Bar: 3 ulp,
    at most 2% of points apart at all, exact at 0."""
    u = np.concatenate([np.linspace(0.0, 1.0, 1 << 16, endpoint=False),
                        [2.0**-24, 1.0 - 2.0**-24]]).astype(np.float32)
    got = rng.cbrt(torch.from_numpy(u)).numpy()
    want = np.asarray(jnp.cbrt(jnp.asarray(u)))
    ulp = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32).astype(np.int64))
    assert ulp.max() <= 3, ulp.max()
    assert (ulp > 0).mean() <= 0.02
    assert got[0] == 0.0
