"""rtweekend_tpu_torch's differentiable replay (ops/replay.py) against
rtweekend_tpu.ops.replay on the same winners: the Pallas kernel's
want_winners output (interpret mode), carried to the port as numpy, with
the same camera rays. Also sky_color and Perlin noise/turb against JAX.

Both replays evaluate the same formulas in the same order over the same
paths, so radiance agrees to f32 rounding: rtol 1e-5, atol 1e-6 (the
bar tests/test_replay.py holds two JAX replays to) on random_scene,
earth and final_scene bit for bit as measured. XLA and PyTorch still
round a few products and sums differently, and two textures amplify a
last-bit difference in the hit point or direction: the noise texture's
sin(scale z + 10 turb(p)) (7 octaves up to 64x the base frequency) and
the gradient sky after a refraction near grazing. So at most 0.5% of
radiance elements (the lane bar of tests/test_pallas.py) may miss the
rtol 1e-5 / atol 1e-6 bar, and every element is within atol 1e-3 (the
noise case measured 2.4e-4 on one element of 864, the gradient sky
5.4e-6 on one). Gradients agree at
rtol 1e-4, atol 1e-6 (the same file's gradient bar), except the sphere
centers and radii of scenes with a large ground sphere: a ray grazing it
has d t / d param ~ 1/sqrt(disc), which amplifies f32 rounding
differences between the two frameworks (tests/test_sharding.py:138-145),
so those two are held by relative L2 <= 1e-3.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtweekend_tpu.models.builders import build_scene as jax_build_scene
from rtweekend_tpu.ops.camera import generate_rays as jax_generate_rays
from rtweekend_tpu.ops.integrator import sky_color as jax_sky_color
from rtweekend_tpu.ops.pallas.megakernel import trace_paths_pallas
from rtweekend_tpu.ops.replay import replay_tables as jax_replay_tables
from rtweekend_tpu.ops.replay import trace_paths_replay_fast as jax_replay
from rtweekend_tpu.parallel.shard import extract_params as jax_extract_params
from rtweekend_tpu.parallel.shard import merge_params as jax_merge_params
from rtweekend_tpu.render import camera_for_scene as jax_camera_for_scene
from rtweekend_tpu.utils import perlin as jax_perlin
from rtweekend_tpu_torch.convert import params_from_numpy, params_to_numpy
from rtweekend_tpu_torch.models.builders import build_scene
from rtweekend_tpu_torch.ops.integrator import sky_color
from rtweekend_tpu_torch.ops.replay import replay_tables, trace_paths_replay_fast
from rtweekend_tpu_torch.parallel.shard import extract_params, merge_params
from rtweekend_tpu_torch.utils import perlin

from test_torch_megakernel import one_torch_thread  # noqa: F401  (autouse)

W = H = 12
SPP = 2
DEPTH = 4
SEED = 11
SKY = ((1.0, 1.0, 1.0), (0.5, 0.7, 1.0))

# (case id, scene, kernel background, replay background, has a ground sphere)
CASES = {
    "simple_light": ("simple_light", (0.0, 0.0, 0.0), (0.0, 0.0, 0.0), True),
    "random_scene": ("random_scene", (0.7, 0.8, 1.0), (0.7, 0.8, 1.0), True),
    "earth": ("earth", (0.7, 0.8, 1.0), (0.7, 0.8, 1.0), False),
    "final_scene": ("final_scene", (0.7, 0.8, 1.0), (0.7, 0.8, 1.0), True),
    # tests/test_replay.py:85-97: flat-sky winners replayed under the
    # gradient sky (a miss is a miss whatever the sky's color)
    "gradient_sky": ("random_scene", (0.7, 0.8, 1.0), SKY, True),
}


@functools.lru_cache(maxsize=None)
def _setup(case):
    name, kbg, rbg, _ = CASES[case]
    scene = jax_build_scene(name)
    camera = jax_camera_for_scene(name, aspect_ratio=1.0)
    n_pix = W * H
    pids = jnp.repeat(jnp.arange(n_pix, dtype=jnp.int32), SPP)
    sids = jnp.tile(jnp.arange(SPP, dtype=jnp.int32), n_pix)
    o, d, t = jax_generate_rays(camera, W, H, pids, sids, jnp.uint32(SEED))
    _, winners = trace_paths_pallas(
        scene, o, d, t, pids, sids, jnp.uint32(SEED), jnp.asarray(kbg, jnp.float32),
        DEPTH, interpret=True, return_winners=True,
    )
    jargs = (o, d, t, pids, sids, jnp.uint32(SEED), jnp.asarray(rbg, jnp.float32), winners)
    targs = [torch.from_numpy(np.array(x)) for x in (o, d, t, pids, sids)]
    targs += [SEED, torch.tensor(rbg, dtype=torch.float32),
              torch.from_numpy(np.array(winners))]
    return scene, jargs, build_scene(name, device="cpu"), targs


def test_replay_tables_match_jax():
    scene, _, tscene, _ = _setup("earth")
    jf, ji = jax_replay_tables(scene)
    f, i = replay_tables(tscene)
    np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))


@pytest.mark.parametrize("case", list(CASES))
def test_replay_radiance_matches_jax(case):
    scene, jargs, tscene, targs = _setup(case)
    want = np.asarray(jax_replay(scene, *jargs))
    got = trace_paths_replay_fast(tscene, *targs).numpy()
    assert want.shape == got.shape == (W * H * SPP, 3)
    assert want.mean() > 0.0
    off = np.abs(got - want) > 1e-6 + 1e-5 * np.abs(want)
    assert off.mean() <= 0.005, f"{off.sum()} of {off.size} elements off"
    np.testing.assert_allclose(got, want, rtol=0.0, atol=1e-3)
    # remat only changes what autograd keeps, never the value
    np.testing.assert_array_equal(
        trace_paths_replay_fast(tscene, *targs, remat=False).numpy(), got)


def _rel_l2(got, want):
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


@pytest.mark.parametrize("case", list(CASES))
def test_replay_grads_match_jax(case):
    scene, jargs, tscene, targs = _setup(case)
    ground = CASES[case][3]

    def jloss(params, bg):
        rad = jax_replay(jax_merge_params(scene, params), *jargs[:6], bg, jargs[7])
        return jnp.mean(rad)

    jparams = jax_extract_params(scene)
    want, want_bg = jax.grad(jloss, argnums=(0, 1))(jparams, jargs[6])
    params = {k: v.requires_grad_(True) for k, v in
              params_from_numpy({k: np.asarray(v) for k, v in jparams.items()},
                                "cpu").items()}
    bg = targs[6].clone().requires_grad_(True)
    rad = trace_paths_replay_fast(merge_params(tscene, params), *targs[:6], bg, targs[7])
    grads = torch.autograd.grad(rad.mean(), list(params.values()) + [bg])
    got = params_to_numpy(dict(zip(params, grads[:-1])))
    got_bg = grads[-1].numpy()
    for k, w in want.items():
        w = np.asarray(w)
        assert np.isfinite(got[k]).all(), k
        if ground and k in ("c0", "radius"):
            assert _rel_l2(got[k], w) <= 1e-3, (k, _rel_l2(got[k], w))
        else:
            np.testing.assert_allclose(got[k], w, rtol=1e-4, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(got_bg, np.asarray(want_bg), rtol=1e-4, atol=1e-6)
    # earth's image texture is a nearest-texel lookup: only the sky has a gradient
    assert sum(np.abs(g).sum() for g in got.values()) + np.abs(got_bg).sum() > 0.0


def test_replay_grads_finite_final_scene_depth8():
    """Every guard of the JAX replay is kept: no NaN reaches a gradient
    through an unselected branch, on the 488-sphere scene at depth 8."""
    _, _, tscene, targs = _setup("final_scene")
    winners = torch.cat([targs[7], targs[7]])  # 8 bounces of real winners
    params = {k: v.detach().requires_grad_(True) for k, v in extract_params(tscene).items()}
    rad = trace_paths_replay_fast(merge_params(tscene, params), *targs[:7], winners)
    grads = torch.autograd.grad((rad * rad).mean(), list(params.values()))
    for k, g in zip(params, grads):
        assert torch.isfinite(g).all(), k


def test_sky_color_matches_jax():
    d = np.random.default_rng(5).normal(size=(64, 3)).astype(np.float32)
    d[0] = 0.0  # the zero-direction guard
    for bg in ((0.7, 0.8, 1.0), SKY):
        want = np.asarray(jax_sky_color(jnp.asarray(bg, jnp.float32), jnp.asarray(d)))
        got = sky_color(torch.tensor(bg), torch.from_numpy(d)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_perlin_noise_turb_match_jax():
    """Values at rtol 1e-5 and gradients in the query points at rtol 1e-4
    (both sides: the same gathers and Hermite products)."""
    grad, px, py, pz = jax_perlin.make_tables(42)
    p = np.random.default_rng(6).uniform(-20.0, 20.0, size=(256, 3)).astype(np.float32)
    jt = [jnp.asarray(x) for x in (grad, px, py, pz)]
    tt = [torch.from_numpy(x) for x in (grad, px, py, pz)]
    for fn, jfn in ((perlin.noise, jax_perlin.noise), (perlin.turb, jax_perlin.turb)):
        want = np.asarray(jfn(*jt, jnp.asarray(p)))
        want_g = np.asarray(jax.grad(lambda q: jnp.sum(jfn(*jt, q) ** 2))(jnp.asarray(p)))
        q = torch.from_numpy(p).requires_grad_(True)
        got = fn(*tt, q)
        (got_g,) = torch.autograd.grad(torch.sum(got ** 2), q)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got_g.numpy(), want_g, rtol=1e-4, atol=1e-5)
