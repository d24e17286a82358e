"""rtweekend_tpu_torch scene builders, conversion, coefficient rows and
kernel tables against rtweekend_tpu. All host-side data: bit-equal."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtweekend_tpu.config import SCENE_DEFAULTS
from rtweekend_tpu.models.builders import build_scene as jax_build_scene
from rtweekend_tpu.ops import coeffs as jax_coeffs
from rtweekend_tpu.ops.pallas.megakernel import _pack_scene as jax_pack_scene
from rtweekend_tpu_torch.config import SCENE_DEFAULTS as PORT_DEFAULTS
from rtweekend_tpu_torch.convert import scene_from_numpy
from rtweekend_tpu_torch.models.builders import build_scene
from rtweekend_tpu_torch.models.scene import LEAF_GROUPS, TOP_LEAVES
from rtweekend_tpu_torch.ops import coeffs
from rtweekend_tpu_torch.ops.cuda.megakernel import pack_scene

from test_torch_megakernel import one_torch_thread  # noqa: F401  (autouse)

META = ("n_spheres", "n_rects", "has_checker", "has_noise", "has_image", "has_motion")


def jax_leaves(scene):
    """A JAX Scene's leaves as numpy, keyed as convert.scene_from_numpy wants."""
    out = {}
    for f in dataclasses.fields(scene):
        v = getattr(scene, f.name)
        if f.name in META:
            continue
        if dataclasses.is_dataclass(v):
            for g in dataclasses.fields(v):
                out[f"{f.name}.{g.name}"] = np.asarray(getattr(v, g.name))
        else:
            out[f.name] = np.asarray(v)
    return out


def scene_to_numpy(scene):
    """Every leaf of a port Scene as numpy, keyed as jax_leaves keys them."""
    out = {f"{g}.{f.name}": getattr(getattr(scene, g), f.name).cpu().numpy()
           for g, cls in LEAF_GROUPS.items() for f in dataclasses.fields(cls)}
    out.update({k: getattr(scene, k).cpu().numpy() for k in TOP_LEAVES})
    return out


def assert_leaves_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_scene_defaults_match():
    assert PORT_DEFAULTS == SCENE_DEFAULTS


@pytest.mark.parametrize("name", sorted(SCENE_DEFAULTS))
def test_build_scene_leaves_equal_jax(name):
    jscene = jax_build_scene(name, seed=42)
    scene = build_scene(name, seed=42, device="cpu")
    assert_leaves_equal(scene_to_numpy(scene), jax_leaves(jscene))
    for m in META:
        assert getattr(scene, m) == getattr(jscene, m), m


@pytest.mark.parametrize("name", ["final_scene", "cornell_box", "earth"])
def test_scene_from_numpy_equals_port_build(name):
    converted = scene_from_numpy(jax_leaves(jax_build_scene(name, seed=42)), device="cpu")
    built = build_scene(name, seed=42, device="cpu")
    assert_leaves_equal(scene_to_numpy(converted), scene_to_numpy(built))
    for m in META:
        assert getattr(converted, m) == getattr(built, m), m


def test_scene_from_numpy_rejects_missing_leaf():
    leaves = jax_leaves(jax_build_scene("cornell_box"))
    del leaves["rects.k"]
    with pytest.raises(KeyError, match="rects.k"):
        scene_from_numpy(leaves, device="cpu")


@pytest.mark.parametrize("name", ["final_scene", "cornell_box"])
def test_pack_tables_bit_equal(name):
    want = jax_pack_scene(jax_build_scene(name, seed=42))
    t = pack_scene(build_scene(name, seed=42, device="cpu"))
    got = (t.coef, t.attr_f, t.attr_i, t.perm, t.grad, t.images)
    for g, w, label in zip(got, want, ("coef", "attr_f", "attr_i", "perm", "grad", "images")):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype, label
        np.testing.assert_array_equal(g.numpy(), w, err_msg=label)


def test_ray_features_match_jax():
    r = np.random.default_rng(5)
    o, d = (r.normal(0, 5, (128, 3)).astype(np.float32) for _ in range(2))
    t = r.uniform(0, 1, 128).astype(np.float32)
    got = coeffs.ray_features(*map(torch.from_numpy, (o, d, t)))
    want = jax_coeffs.ray_features(*map(jnp.asarray, (o, d, t)))
    assert got.shape == (128, coeffs.NF)
    # 3-term dot products: XLA may fuse a multiply-add
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-5)


def test_candidate_t_epilogues_match_jax():
    """quadratic_t / rect_t on random candidates, including misses; both
    are elementwise f32 formulas, so equal to f32 rounding. A root is the
    difference of |hb| and sqrt(disc), both ~10 here, and XLA may fuse
    the discriminant's multiply-add: a few ulp of 10 absolute (atol)."""
    r = np.random.default_rng(11)
    hb, cc = (r.normal(0, 4, (256, 8)).astype(np.float32) for _ in range(2))
    a = r.uniform(0.5, 2.0, (256, 1)).astype(np.float32)
    inv_a = (1.0 / a).astype(np.float32)
    got = coeffs.quadratic_t(*map(torch.from_numpy, (hb, cc, a, inv_a)), coeffs.T_MIN)
    want = jax_coeffs.quadratic_t(*map(jnp.asarray, (hb, cc, a, inv_a)), coeffs.T_MIN)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-5)
    six = [r.normal(0, 2, (256, 8)).astype(np.float32) for _ in range(6)]
    six[1][::7] = 0.0  # dn == 0: miss
    got = coeffs.rect_t(*map(torch.from_numpy, six), coeffs.T_MIN)
    want = jax_coeffs.rect_t(*map(jnp.asarray, six), coeffs.T_MIN)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
