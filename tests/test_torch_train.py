"""rtweekend_tpu_torch.parallel.shard.sharded_train_step (one device,
streamed winner blocks) against the JAX package's sharded_train_step on
a 1x1 mesh with use_pallas=True (the Pallas kernel in interpret mode),
on book1_metal_dielectric (diffuse, fuzzy metal and hollow glass under a
flat sky) at 16x16, 4 spp, depth 3, lr 1.0, so that p0 - p1 is the
gradient.

Bars, as tests/test_sharding.py:167-221 holds the JAX streaming step:
the loss comes from the kernels' own radiance (port: plain version; JAX:
interpret-mode Pallas), which differ by f32 reassociation, rtol 2e-4;
gradients rtol 2e-3 / atol 1e-6 (the residual is taken at each side's
kernel mean image). Several streamed blocks against one block: loss
rtol 1e-5, parameters rtol 1e-3 / atol 1e-7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtweekend_tpu.models.builders import build_scene as jax_build_scene
from rtweekend_tpu.parallel.mesh import make_mesh
from rtweekend_tpu.parallel.shard import extract_params as jax_extract_params
from rtweekend_tpu.parallel.shard import sharded_train_step as jax_train_step
from rtweekend_tpu.render import camera_for_scene as jax_camera_for_scene
from rtweekend_tpu_torch.convert import params_from_numpy, params_to_numpy
from rtweekend_tpu_torch.models.builders import build_scene
from rtweekend_tpu_torch.parallel.shard import extract_params, sharded_train_step
from rtweekend_tpu_torch.render import camera_for_scene

from test_torch_megakernel import one_torch_thread  # noqa: F401  (autouse)

NAME = "book1_metal_dielectric"
W = H = 16
SPP = 4
DEPTH = 3
BG = (0.7, 0.8, 1.0)
TARGET = np.random.default_rng(0).uniform(0.2, 0.9, (H, W, 3)).astype(np.float32)


def _port(**kw):
    scene = build_scene(NAME, device="cpu")
    cam = camera_for_scene(NAME, 1.0, "cpu")
    p0 = params_to_numpy(extract_params(scene))
    p1, loss = sharded_train_step(scene, cam, torch.from_numpy(TARGET), W, H, SPP, DEPTH,
                                  BG, 43, lr=1.0, kernel="torch", **kw)
    return p0, params_to_numpy(p1), float(loss)


def test_train_step_matches_jax():
    scene = jax_build_scene(NAME)
    cam = jax_camera_for_scene(NAME, aspect_ratio=1.0)
    mesh = make_mesh((1, 1), jax.devices()[:1])
    jp0 = {k: np.asarray(v) for k, v in jax_extract_params(scene).items()}
    jp1, jloss = jax_train_step(scene, cam, jnp.asarray(TARGET), W, H, SPP, DEPTH,
                                jnp.asarray(BG, jnp.float32), 43, mesh, lr=1.0,
                                use_pallas=True, interpret=True)
    p0, p1, loss = _port()
    np.testing.assert_allclose(loss, float(jloss), rtol=2e-4)
    for k in jp0:
        np.testing.assert_array_equal(p0[k], jp0[k])
        want = jp0[k] - np.asarray(jp1[k])
        np.testing.assert_allclose(p0[k] - p1[k], want, rtol=2e-3, atol=1e-6, err_msg=k)
    assert np.abs(p0["color"] - p1["color"]).sum() > 0.0


def test_streamed_blocks_match_single_block():
    """rays_per_chunk=256 = one sample of the 16x16 image per block: four
    blocks of winners, one VJP each, against all four samples at once."""
    p0, one, loss_one = _port()
    _, many, loss_many = _port(rays_per_chunk=W * H)
    np.testing.assert_allclose(loss_many, loss_one, rtol=1e-5)
    for k in one:
        np.testing.assert_allclose(many[k], one[k], rtol=1e-3, atol=1e-7, err_msg=k)
        assert np.isfinite(many[k]).all()


def test_params_round_trip():
    jp = {k: np.asarray(v) for k, v in jax_extract_params(jax_build_scene(NAME)).items()}
    port = params_from_numpy(jp, "cpu")
    assert all(isinstance(v, torch.Tensor) and v.device.type == "cpu" for v in port.values())
    back = params_to_numpy(port)
    own = params_to_numpy(extract_params(build_scene(NAME, device="cpu")))
    for k in jp:
        np.testing.assert_array_equal(back[k], jp[k])
        np.testing.assert_array_equal(own[k], jp[k])


def test_train_step_refuses_unported_branches():
    """An object that is not a (tiles, samples) DeviceMesh is refused with
    TypeError (tests/test_torch_multidevice.py runs real meshes);
    use_pallas=False, the eager integrator, runs
    (tests/test_torch_eager_train.py holds it against JAX), and under this
    flat sky its geometry gradients are zero."""
    scene = build_scene(NAME, device="cpu")
    cam = camera_for_scene(NAME, 1.0, "cpu")
    args = (scene, cam, torch.from_numpy(TARGET), W, H, SPP, DEPTH, BG, 43)
    with pytest.raises(TypeError, match="DeviceMesh"):
        sharded_train_step(*args, mesh=object())
    p1, loss = sharded_train_step(*args, lr=1.0, use_pallas=False)
    p0 = extract_params(scene)
    assert torch.isfinite(loss)
    torch.testing.assert_close(p1["c0"], p0["c0"], rtol=0, atol=0)
    assert (p1["color"] != p0["color"]).any()


def test_kernel_path_raises_on_a_leaf_the_replay_does_not_reach(monkeypatch):
    """The eager branch takes a leaf its graph never reaches as a zero
    gradient; the kernel path's replay reads every leaf through its
    tables, so there an unreached leaf stays an error."""
    from rtweekend_tpu_torch.parallel import shard

    real = shard.trace_paths_replay_fast

    def replay_without_ior(scene, *a, **kw):
        rad = real(scene, *a, **kw)
        return rad.detach() * 0.0 + scene.textures.color.sum() + scene.spheres.c0.sum() \
            + scene.spheres.radius.sum() + scene.materials.fuzz.sum()

    monkeypatch.setattr(shard, "trace_paths_replay_fast", replay_without_ior)
    scene = build_scene(NAME, device="cpu")
    cam = camera_for_scene(NAME, 1.0, "cpu")
    with pytest.raises(RuntimeError, match="not have been used"):
        sharded_train_step(scene, cam, torch.from_numpy(TARGET), W, H, SPP, DEPTH, BG, 43,
                           kernel="torch")
