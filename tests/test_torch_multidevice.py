"""rtweekend_tpu_torch.parallel (render_sharded, sharded_train_step(mesh=),
make_mesh) on real process groups: gloo on the CPU, one OS process a rank
(tests/torch_multiproc_worker.py), launched once at world size 4 (meshes
(4, 1), (2, 2), (1, 4), as tests/test_sharding.py uses) and once at world
size 1 (mesh (1, 1)). This pytest process joins no process group.

Scene and sizes of tests/test_sharding.py: simple_light 16x16, 4 spp, depth
3, render seed 42, train seed 43, lr 1 (so p0 - p1 is the gradient), the
target the port's render / spp. Bars:
- render_sharded against the port's render: rtol 1e-4 / atol 1e-4
  (tests/test_sharding.py:32-44); mesh (1, 1) bit-equal;
- against the JAX package's render_sharded on the virtual-device mesh
  (2, 2), jnp path: the lane bars of tests/test_pallas.py (<= 0.5% of
  lanes off by > 1e-3, channel means within 2%);
- the train step against the port's mesh=None step: loss rtol 1e-5,
  gradients rtol 2e-3 / atol 2e-6 (tests/test_sharding.py:59-100); mesh
  (1, 1) bit-equal; every rank's parameters bit-identical;
- the kernel path's loss against the JAX step's loss at rtol 2e-4
  (tests/test_sharding.py:167). The JAX jnp step at mesh (2, 2) compiles
  for ~3 minutes on the CPU, so its loss is taken from its own forward:
  JAX render_sharded on the same mesh at the train seed, jitted, whose
  spp-mean against the target is the loss that step returns;
- the dry-run shape (`__graft_entry__.dryrun_multichip`: rays_per_chunk 64
  streams two winner blocks a rank at (2, 2)) against one block: loss
  rtol 1e-5, parameters rtol 1e-3 / atol 1e-7 (tests/test_sharding.py:
  214-221).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_multiproc_worker as worker
from rtweekend_tpu.models.builders import build_scene as jax_build_scene
from rtweekend_tpu.parallel.mesh import make_mesh as jax_make_mesh
from rtweekend_tpu.parallel.shard import render_sharded as jax_render_sharded
from rtweekend_tpu.render import camera_for_scene as jax_camera_for_scene
from rtweekend_tpu_torch.convert import params_to_numpy
from rtweekend_tpu_torch.models.builders import build_scene
from rtweekend_tpu_torch.parallel.shard import extract_params, sharded_train_step
from rtweekend_tpu_torch.render import camera_for_scene, render

from test_torch_megakernel import one_torch_thread  # noqa: F401  (autouse)

W, H, SPP, DEPTH = worker.W, worker.H, worker.SPP, worker.DEPTH
BG = (0.0, 0.0, 0.0)
TAGS = ("4x1", "2x2", "1x4")
LANE_TOL, LANE_FRAC, MEAN_RTOL = 1e-3, 0.005, 0.02


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory):
    return worker.launch("multidevice", 4, tmp_path_factory.mktemp("world4"))


@pytest.fixture(scope="module")
def ranks1(tmp_path_factory):
    return worker.launch("multidevice", 1, tmp_path_factory.mktemp("world1"))


@pytest.fixture(scope="module")
def port():
    scene = build_scene("simple_light", device="cpu")
    cam = camera_for_scene("simple_light", 1.0, "cpu")
    single = render(scene, cam, W, H, SPP, DEPTH, BG, worker.SEED)
    return scene, cam, single


@pytest.fixture(scope="module")
def unsharded(port):
    """The port's mesh=None train steps: {branch: (p0, p1, loss)}."""
    scene, cam, single = port
    p0 = params_to_numpy(extract_params(scene))
    out = {}
    for branch, kw in (("kernel", {}), ("eager", dict(use_pallas=False))):
        p1, loss = sharded_train_step(scene, cam, single / SPP, W, H, SPP, DEPTH, BG,
                                      worker.TRAIN_SEED, lr=1.0, **kw)
        out[branch] = (p0, params_to_numpy(p1), float(loss))
    return out


@pytest.fixture(scope="module")
def jax_fb():
    """JAX render_sharded on the virtual-device mesh (2, 2), jnp path, at
    the render seed and the train seed (one compile: the seed is traced)."""
    scene = jax_build_scene("simple_light")
    cam = jax_camera_for_scene("simple_light", aspect_ratio=1.0)
    mesh = jax_make_mesh((2, 2), jax.devices()[:4])
    fn = jax.jit(lambda seed: jax_render_sharded(scene, cam, W, H, SPP, DEPTH, BG, seed, mesh))
    return {s: np.asarray(fn(jnp.uint32(s))) for s in (worker.SEED, worker.TRAIN_SEED)}


def _grads(p0, p1):
    return {k: p0[k] - p1[k] for k in p0}


@pytest.mark.parametrize("tag", TAGS)
def test_render_sharded_matches_render(ranks4, port, tag):
    single = port[2].numpy()
    for res in ranks4:
        np.testing.assert_allclose(res[f"render_{tag}"], single, rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(res[f"render_{tag}"], ranks4[0][f"render_{tag}"])
    assert single.shape == (H, W, 3) and single.max() > 0.0


@pytest.mark.parametrize("tag", TAGS)
def test_mesh_coordinates(ranks4, tag):
    """Rank r sits at (r // S, r % S) of a (T, S) mesh: tiles outer."""
    s = int(tag.split("x")[1])
    for rank, res in enumerate(ranks4):
        assert int(res["world"]) == 4 and int(res["rank"]) == rank
        assert str(res["backend"]) == "gloo" and str(res["device"]) == "cpu"
        assert list(res[f"coord_{tag}"]) == [rank // s, rank % s]


def test_render_sharded_1x1_bit_equal(ranks1, port):
    np.testing.assert_array_equal(ranks1[0]["render_1x1"], port[2].numpy())


def test_render_sharded_matches_jax(ranks4, jax_fb):
    got, want = ranks4[0]["render_2x2"], jax_fb[worker.SEED]
    off = np.abs(got - want) > LANE_TOL
    assert off.mean() <= LANE_FRAC, f"{off.mean():.4f} of lanes off by > {LANE_TOL}"
    np.testing.assert_allclose(got.reshape(-1, 3).mean(0), want.reshape(-1, 3).mean(0),
                               rtol=MEAN_RTOL)


def test_render_sharded_eager_matches_render(ranks4, port):
    scene, cam, _ = port
    want = render(scene, cam, W, H, SPP, DEPTH, BG, worker.SEED, kernel="eager").numpy()
    for res in ranks4:
        np.testing.assert_allclose(res["render_eager_2x2"], want, rtol=1e-4, atol=1e-4)


def test_indivisible_mesh_raises(ranks4):
    """15x15 pixels over the default mesh (4, 1): ValueError on every rank."""
    assert all(bool(res["indivisible_raises"]) for res in ranks4)


@pytest.mark.parametrize("tag,branch", [("4x1", "kernel"), ("2x2", "kernel"),
                                        ("1x4", "kernel"), ("eager_2x2", "eager")])
def test_train_step_matches_unsharded(ranks4, unsharded, tag, branch):
    p0, p1, loss = unsharded[branch]
    res = ranks4[0]
    np.testing.assert_allclose(float(res[f"train_{tag}_loss"]), loss, rtol=1e-5)
    got = _grads(p0, {k: res[f"train_{tag}_{k}"] for k in p0})
    for k, want in _grads(p0, p1).items():
        np.testing.assert_allclose(got[k], want, rtol=2e-3, atol=2e-6, err_msg=k)
    assert np.abs(got["color"]).sum() > 0.0


@pytest.mark.parametrize("tag", ["4x1", "2x2", "1x4", "eager_2x2", "dryrun_2x2"])
def test_train_step_params_identical_on_every_rank(ranks4, tag):
    keys = [k for k in ranks4[0] if k.startswith(f"train_{tag}_")]
    assert len(keys) == 6   # loss and five parameter groups
    for res in ranks4[1:]:
        for k in keys:
            np.testing.assert_array_equal(res[k], ranks4[0][k], err_msg=k)


def test_train_step_loss_matches_jax(ranks4, jax_fb, port):
    target = port[2].numpy() / SPP
    err = jax_fb[worker.TRAIN_SEED].astype(np.float64) / SPP - target
    np.testing.assert_allclose(float(ranks4[0]["train_2x2_loss"]), np.mean(err * err),
                               rtol=2e-4)


def test_dryrun_blocks_match_single_block(ranks4):
    """rays_per_chunk=64 at (2, 2): two streamed winner blocks a rank,
    against one block a rank."""
    for res in ranks4:
        assert int(res["dryrun_winner_blocks"]) == 2
    res = ranks4[0]
    np.testing.assert_allclose(float(res["train_dryrun_2x2_loss"]),
                               float(res["train_2x2_loss"]), rtol=1e-5)
    for k in ("c0", "radius", "color", "fuzz", "ior"):
        many, one = res[f"train_dryrun_2x2_{k}"], res[f"train_2x2_{k}"]
        np.testing.assert_allclose(many, one, rtol=1e-3, atol=1e-7, err_msg=k)
        assert np.isfinite(many).all()


def test_train_step_1x1_bit_equal(ranks1, unsharded):
    _, p1, loss = unsharded["kernel"]
    res = ranks1[0]
    assert float(res["train_1x1_loss"]) == loss
    for k in p1:
        np.testing.assert_array_equal(res[f"train_1x1_{k}"], p1[k], err_msg=k)


def test_train_step_refuses_a_mesh_it_cannot_use(port):
    """Not a DeviceMesh: TypeError, before any collective."""
    scene, cam, single = port
    with pytest.raises(TypeError, match="DeviceMesh"):
        sharded_train_step(scene, cam, single / SPP, W, H, SPP, DEPTH, BG, 43,
                           mesh=(2, 2))
    assert torch.isfinite(single).all()


def test_eager_blocks_plan_on_the_card_share(monkeypatch):
    """Ranks that share a card size their eager blocks for their share of
    its free memory, not each for all of it."""
    from types import SimpleNamespace

    from rtweekend_tpu_torch.parallel import shard

    scene = SimpleNamespace(
        device=torch.device("cuda", 0),
        spheres=SimpleNamespace(radius=torch.zeros(30), c0=torch.zeros(30, 3)),
        rects=SimpleNamespace(k=torch.zeros(2)))
    per_ray = 32 * 4 * shard.EAGER_WORKSPACES
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda dev: (1000 * per_ray, 0))
    assert shard.eager_rays_per_chunk(scene, 1 << 20) == 500
    assert shard.eager_rays_per_chunk(scene, 1 << 20, ranks_on_card=2) == 250
    assert shard.eager_rays_per_chunk(scene, 100, ranks_on_card=2) == 100
