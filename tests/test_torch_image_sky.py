"""The bounce kernel's image-texture (K1g) and gradient-sky (K1i)
variants in rtweekend_tpu_torch: the plain version against the Pallas
kernel of rtweekend_tpu (interpret mode, as tests/test_pallas.py runs it
on the CPU), and the Cephes atan2/acos against the TPU kernel's own.

Bars: earth (1024 rays, depth 6) takes tests/test_pallas.py:72-91's
texture-scene bar: at most 0.5% of lanes off by more than 1e-3, channel
means within 2% plus atol 5e-3 (a texel at a boundary can move with the
hit point's last bits), and so does a scene that needs every texture
variant, motion and the sky at once. golden_scene (depth 8, ~490
spheres and glass) takes the final_scene bar: the same lane bar,
channel means within 2%.
atan2/acos: both sides run the same float32 operations on the CPU (XLA
and PyTorch), but XLA fuses a multiply and an add into one rounding
where PyTorch rounds twice (the CUDA kernel fuses too): atan2 at most
1 ulp apart; acos at most 2 (its 1 - c^2 is fused on both sides, and
the 1 ulp of the inner atan2 can gain one in the quadrant fix-up
pi - p).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtweekend_tpu.models import builders as jax_builders
from rtweekend_tpu.models import scene as jax_scene
from rtweekend_tpu.ops.pallas import megakernel as jax_mk
from rtweekend_tpu_torch.models import builders
from rtweekend_tpu_torch.models import scene as port_scene
from rtweekend_tpu_torch.ops.cuda import megakernel as mk

from test_torch_cuda import SKY, mixed_scene
from test_torch_megakernel import _plain_vs_pallas, one_torch_thread  # noqa: F401


@pytest.fixture(scope="module", params=[("earth", 6, 5e-3), ("golden_scene", 8, 0.0)])
def parity(request):
    """(scene, port radiance, JAX interpret-mode radiance, means atol):
    each JAX reference is computed once for the module."""
    name, depth, atol = request.param
    got, want = _plain_vs_pallas(name, depth, 1.0)
    return name, got, want, atol


def test_plain_vs_pallas_image_and_sky(parity):
    name, got, want, atol = parity
    assert np.isfinite(got).all()
    assert want.mean() > 0.1, name  # sky-lit
    diverged = (np.abs(got - want) > 1e-3).mean()
    assert diverged < 0.005, f"{name}: too many diverged lanes: {diverged}"
    np.testing.assert_allclose(got.mean(axis=0), want.mean(axis=0), rtol=0.02, atol=atol)


def test_plain_vs_pallas_mixed_variants():
    """Noise, image (on a sphere and on a rect), motion and the gradient
    sky in one scene, with the texture-scene bar: the combination the
    kernel's general instantiation serves."""
    scenes = mixed_scene(jax_scene).build(), mixed_scene(port_scene).build("cpu")
    got, want = _plain_vs_pallas("two_perlin_spheres", 6, 1.0, scenes=scenes, bg=SKY)
    assert np.isfinite(got).all() and want.mean() > 0.1
    diverged = (np.abs(got - want) > 1e-3).mean()
    assert diverged < 0.005, f"too many diverged lanes: {diverged}"
    np.testing.assert_allclose(got.mean(axis=0), want.mean(axis=0), rtol=0.02, atol=5e-3)


def _ulps(got, want):
    return np.abs(got.astype(np.float64) - want) / np.spacing(np.abs(want).astype(np.float32))


def test_atan2_matches_the_tpu_kernel():
    """Every octant, both reductions, the axes and the origin."""
    rng = np.random.default_rng(3)
    ang = rng.uniform(-np.pi, np.pi, 8192)
    rad = rng.uniform(1e-3, 10.0, 8192)
    y = np.concatenate([rad * np.sin(ang), [0.0, 0.0, 1.0, -1.0, 0.0, 0.0, 2.0, -2.0]])
    x = np.concatenate([rad * np.cos(ang), [1.0, -1.0, 0.0, 0.0, 0.0, -0.0, 2.0, -2.0]])
    y, x = y.astype(np.float32), x.astype(np.float32)
    want = np.asarray(jax.jit(jax_mk._atan2)(jnp.asarray(y), jnp.asarray(x)))
    got = mk._atan2(torch.from_numpy(y), torch.from_numpy(x)).numpy()
    assert np.abs(want).max() > 3.1 and (np.sign(want) < 0).any()
    assert _ulps(got, want).max() <= 1.0


def test_acos_matches_the_tpu_kernel():
    """Over the clamped range the kernel uses, poles included."""
    rng = np.random.default_rng(4)
    c = np.concatenate([rng.uniform(-1.0, 1.0, 8192), [-1.0 + 1e-7, 1.0 - 1e-7, 0.0]])
    c = c.astype(np.float32)
    want = np.asarray(jax.jit(jax_mk._acos)(jnp.asarray(c)))
    got = mk._acos(torch.from_numpy(c)).numpy()
    assert want.min() < 1e-3 and want.max() > 3.14
    assert _ulps(got, want).max() <= 2.0


def test_earth_texture_path_matches_the_jax_package():
    """Both packages look for the same earth texture, so they build the
    same earth on any machine; without the file both use the procedural
    map (tests/test_torch_scene.py compares the built scenes)."""
    assert builders.EARTH_TEXTURE_PATH == jax_builders.EARTH_TEXTURE_PATH


@pytest.mark.parametrize("background,has_sky", [
    ((0.7, 0.8, 1.0), False),
    (((1.0, 1.0, 1.0), (0.5, 0.7, 1.0)), True),
])
def test_background_selects_the_sky_variant(background, has_sky):
    bg, sky = mk.sky_floats(background)
    assert sky == has_sky and len(bg) == 6
    assert bg[:3] == tuple(np.float32(np.asarray(background).reshape(-1)[:3]).tolist())
    with pytest.raises(ValueError, match="background"):
        mk.sky_floats((0.7, 0.8))
