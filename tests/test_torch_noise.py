"""The bounce kernel's noise variant (K1f) in rtweekend_tpu_torch: its
plain version against the Pallas kernel of rtweekend_tpu (interpret
mode, as tests/test_pallas.py runs it on the CPU), and its Perlin
turbulence against rtweekend_tpu.utils.perlin.turb.

Bars: tests/test_pallas.py:72-91 for the noise scenes (1024 rays, depth
6): at most 0.5% of lanes off by more than 1e-3, channel means within 2%
plus atol 5e-3. The turbulence is summed in the TPU kernel's order
(cx*wx + cy*wy + cz*wz) and utils.perlin.turb sums the same dot with
jnp.sum: the two differ in the last bits only, atol 1e-6 on values of
order 1 (the largest difference seen is 9e-8).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtweekend_tpu.utils import perlin as jax_perlin
from rtweekend_tpu_torch.models.builders import build_scene
from rtweekend_tpu_torch.ops.cuda import megakernel as mk

from test_torch_megakernel import _plain_vs_pallas, one_torch_thread  # noqa: F401


@pytest.fixture(scope="module", params=["two_perlin_spheres", "simple_light"])
def parity(request):
    """(scene, port radiance, JAX interpret-mode radiance): each JAX
    reference is computed once for the module."""
    got, want = _plain_vs_pallas(request.param, 6, 1.0)
    return request.param, got, want


def test_plain_vs_pallas_noise_scene(parity):
    name, got, want = parity
    assert np.isfinite(got).all()
    assert want.mean() > 0.05, name  # lit: the sky or simple_light's lamp
    diverged = (np.abs(got - want) > 1e-3).mean()
    assert diverged < 0.005, f"{name}: too many diverged lanes: {diverged}"
    np.testing.assert_allclose(got.mean(axis=0), want.mean(axis=0), rtol=0.02, atol=5e-3)


@pytest.mark.parametrize("where", ["near_origin", "far"])
def test_turbulence_matches_jax(where):
    """Negative lattice coordinates (floor, int, & 255 as two's
    complement) near the origin, and |p| ~ 1000 as on the r = 1000
    ground of two_perlin_spheres and simple_light."""
    rng = np.random.default_rng(7)
    lim = 4.0 if where == "near_origin" else 1000.0
    pts = rng.uniform(-lim, lim, size=(4096, 3)).astype(np.float32)
    if where == "far":
        pts[:, 1] = -np.abs(pts[:, 1])  # the ground's lower half-space too
    grad, px, py, pz = jax_perlin.make_tables(42)
    want = np.asarray(jax.jit(lambda p: jax_perlin.turb(
        jnp.asarray(grad), jnp.asarray(px), jnp.asarray(py), jnp.asarray(pz), p))(
        jnp.asarray(pts)))
    tables = mk.pack_scene(build_scene("two_perlin_spheres", device="cpu"))
    q = torch.from_numpy(pts)
    got = mk.perlin_turb(tables.perm.reshape(-1), tables.grad.reshape(-1),
                         q[:, 0], q[:, 1], q[:, 2]).numpy()
    assert (pts < 0).any() and want.max() > 0.3
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
