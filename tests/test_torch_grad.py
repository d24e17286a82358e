"""rtweekend_tpu_torch gradients: the port's trace_paths_fast (plain
bounce version for the winners on the CPU, then the replay under
autograd) against central finite differences at tests/test_grad.py's
bars, against the JAX package's trace_paths_fast and render_mean (Pallas
kernel in interpret mode), and an inverse render that recovers albedo.

The single-sphere scenes here have no grazing ray and few coefficient
rows: kernel winners agree on every ray, so the port and the JAX package
replay the same paths and agree to f32 rounding (grads rtol 1e-4 /
atol 1e-6, the replay gradient bar of tests/test_replay.py; images
rtol 1e-4 / atol 1e-5, tests/test_grad.py's render_mean bar).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rtweekend_tpu.grad import render_mean as jax_render_mean
from rtweekend_tpu.models.scene import Diffuse as JDiffuse
from rtweekend_tpu.models.scene import SceneBuilder as JSceneBuilder
from rtweekend_tpu.models.scene import Solid as JSolid
from rtweekend_tpu.ops.camera import make_camera as jax_make_camera
from rtweekend_tpu.ops.pallas.vjp import trace_paths_fast as jax_trace_paths_fast
from rtweekend_tpu.parallel.shard import extract_params as jax_extract_params
from rtweekend_tpu.parallel.shard import merge_params as jax_merge_params
from rtweekend_tpu_torch.convert import params_to_numpy
from rtweekend_tpu_torch.grad import fit, make_loss, render_mean
from rtweekend_tpu_torch.models.scene import Dielectric, Diffuse, Metal, SceneBuilder, Solid
from rtweekend_tpu_torch.ops.camera import make_camera
from rtweekend_tpu_torch.ops.cuda.vjp import trace_paths_fast
from rtweekend_tpu_torch.parallel.shard import extract_params, merge_params

from test_torch_megakernel import one_torch_thread  # noqa: F401  (autouse)

SEED = 3
BG = (1.0, 1.0, 1.0)


def _interior_rays(n=512):
    """Rays well inside the silhouette of a unit sphere at (0, 0, -3), so
    a small parameter step cannot change the hit set (tests/test_grad.py)."""
    g = np.random.default_rng(0).uniform(-0.08, 0.08, (n, 2)).astype(np.float32)
    o = np.zeros((n, 3), np.float32)
    d = np.stack([g[:, 0], g[:, 1], np.full(n, -1.0, np.float32)], axis=1)
    return (o, d, np.zeros(n, np.float32), np.arange(n, dtype=np.int32),
            np.zeros(n, np.int32))


def _torch_rays(n=512):
    return [torch.from_numpy(x) for x in _interior_rays(n)]


def _sphere(mat, builder=SceneBuilder, center=(0.0, 0.0, -3.0), radius=1.0):
    """One sphere; the port's builder by default, the JAX package's when given."""
    b = builder()
    b.add_sphere(center, radius, b.material(mat))
    return b.build("cpu") if builder is SceneBuilder else b.build()


def _mean_radiance(scene, params, depth, rays):
    rad = trace_paths_fast(merge_params(scene, params), *rays, SEED, BG, depth,
                           kernel="torch")
    return rad.mean()


FD_CASES = {
    # name: (material, param, index, eps, rtol, depth)
    "albedo": (Diffuse(albedo=Solid((0.5, 0.3, 0.2))), "color", (0, 0), 1e-3, 2e-3, 4),
    "center": (Diffuse(albedo=Solid((0.5, 0.3, 0.2))), "c0", (0, 2), 1e-4, 0.05, 4),
    "radius": (Diffuse(albedo=Solid((0.5, 0.3, 0.2))), "radius", 0, 1e-4, 0.05, 4),
    "fuzz": (Metal(albedo=(0.8, 0.7, 0.6), fuzz=0.3), "fuzz", 0, 1e-3, 0.05, 4),
    "ior": (Dielectric(ir=1.5), "ior", 0, 1e-3, 0.1, 6),
}


@pytest.mark.parametrize("case", list(FD_CASES))
def test_gradient_matches_central_fd(case):
    """tests/test_grad.py:97-133 on the port: analytic (detached
    sampling) against a central finite difference of one parameter."""
    mat, key, idx, eps, rtol, depth = FD_CASES[case]
    scene = _sphere(mat)
    rays = _torch_rays()
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in extract_params(scene).items()}
    if key == "color":
        idx = (int(scene.materials.tex_id[0]), idx[1])
    (g,) = torch.autograd.grad(_mean_radiance(scene, params, depth, rays), [params[key]])
    analytic = float(g[idx])

    def at(val):
        p = {k: v.detach().clone() for k, v in params.items()}
        p[key][idx] = val
        with torch.no_grad():
            return float(_mean_radiance(scene, p, depth, rays))

    x0 = float(params[key][idx].detach())
    fd = (at(x0 + eps) - at(x0 - eps)) / (2 * eps)
    np.testing.assert_allclose(analytic, fd, rtol=rtol, atol=1e-4)


def test_trace_paths_fast_grads_match_jax():
    """tests/test_grad.py:164-201's scene: the port's kernel winners +
    replay against the JAX package's Pallas winners + replay."""
    mat = (0.5, 0.3, 0.2)
    jscene = _sphere(JDiffuse(albedo=JSolid(mat)), JSceneBuilder)
    scene = _sphere(Diffuse(albedo=Solid(mat)))
    rays = _interior_rays(256)
    jrays = [jnp.asarray(x) for x in rays]
    depth = 4

    def jf(params):
        sc = jax_merge_params(jscene, params)
        return jnp.mean(jax_trace_paths_fast(sc, *jrays, jnp.uint32(SEED),
                                             jnp.asarray(BG), depth, 1e-3, True))

    want_v, want = jax.value_and_grad(jf)(jax_extract_params(jscene))
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in extract_params(scene).items()}
    v = _mean_radiance(scene, params, depth, [torch.from_numpy(x) for x in rays])
    got = params_to_numpy(dict(zip(params, torch.autograd.grad(v, list(params.values())))))
    np.testing.assert_allclose(float(v.detach()), float(want_v), rtol=1e-5)
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def test_render_mean_and_loss_match_jax():
    """render_mean through kernel winners + replay against JAX
    render_mean(use_pallas=True) (tests/test_grad.py:204-224), and the
    MSE loss and its color gradient through make_loss."""
    mat = (0.5, 0.3, 0.2)
    jscene = _sphere(JDiffuse(albedo=JSolid(mat)), JSceneBuilder)
    scene = _sphere(Diffuse(albedo=Solid(mat)))
    cam_args = ((0, 0, 0), (0, 0, -1), (0, 1, 0), 60.0, 1.0, 0.0, 1.0, 0.0, 1.0)
    jcam = jax_make_camera(*cam_args)
    cam = make_camera(*cam_args, device="cpu")
    kw = dict(width=8, height=8, spp=2, max_depth=3)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_render_mean(jscene, jcam, BG, jnp.uint32(SEED),
                                          use_pallas=True, **kw))
    got = render_mean(scene, cam, BG, SEED, kernel="torch", **kw)
    assert got.shape == (8, 8, 3)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4, atol=1e-5)

    target = np.full((8, 8, 3), 0.5, np.float32)
    loss = make_loss(scene, cam, torch.from_numpy(target), BG, SEED, kernel="torch", **kw)
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in extract_params(scene).items()}
    value = loss(params)
    (g_color,) = torch.autograd.grad(value, [params["color"]])

    def jloss(color):
        p = dict(jax_extract_params(jscene), color=color)
        img = jax_render_mean(jax_merge_params(jscene, p), jcam, BG, jnp.uint32(SEED),
                              use_pallas=True, **kw)
        return jnp.mean((img - target) ** 2)

    with pltpu.force_tpu_interpret_mode():
        want_v, want_g = jax.value_and_grad(jloss)(jscene.textures.color)
    np.testing.assert_allclose(float(value.detach()), float(want_v), rtol=1e-4)
    np.testing.assert_allclose(g_color.numpy(), np.asarray(want_g), rtol=1e-4, atol=1e-6)


def test_fit_recovers_albedo():
    """tests/test_grad.py:136-161 on the port: perturb the albedo, recover
    it from the target image with Adam (60 steps, lr 0.05, color only)."""
    def build(albedo):
        return _sphere(Diffuse(albedo=Solid(albedo)), center=(0.0, 0.0, -2.0), radius=0.8)

    cam = make_camera((0, 0, 0), (0, 0, -1), (0, 1, 0), 40.0, 1.0, 0.0, 1.0, device="cpu")
    w = h = 24
    true_scene = build((0.6, 0.25, 0.45))
    target = render_mean(true_scene, cam, (0.8, 0.8, 0.8), 9, width=w, height=h, spp=8,
                         max_depth=4, kernel="torch").detach()
    start = build((0.3, 0.5, 0.2))
    fitted, history = fit(start, cam, target, (0.8, 0.8, 0.8), width=w, height=h, spp=4,
                          max_depth=4, steps=60, learning_rate=0.05, seed=1,
                          param_mask={"color": True}, kernel="torch")
    assert history[-1] < history[0] * 0.2, history[::10]
    tid = int(true_scene.materials.tex_id[0])
    np.testing.assert_allclose(fitted.textures.color[tid].numpy(), [0.6, 0.25, 0.45],
                               atol=0.08)
    # masked groups do not move
    torch.testing.assert_close(fitted.spheres.c0, start.spheres.c0, rtol=0, atol=0)

