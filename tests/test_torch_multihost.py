"""rtweekend_tpu_torch.parallel.multihost: initialize, global_mesh and
gather_framebuffer on a real world of two gloo ranks (one OS process
each, tests/torch_multiproc_worker.py), started once from torchrun's
environment variables and once from an explicit tcp:// address, rendering
what tests/test_multiprocess.py renders (two_spheres 16x16, 2 spp, depth 2,
sky (0.7, 0.8, 1.0), seed 42). The gathered framebuffer is held against
the port's render at rtol 1e-4 / atol 1e-4 and against the JAX package's
render at the lane bars of tests/test_pallas.py. initialize's argument
checks run here with no process group, init_process_group replaced by a
recorder (the counterpart of tests/test_multihost.py's passthrough test).
"""

import numpy as np
import pytest
import torch

import torch_multiproc_worker as worker
from rtweekend_tpu.models.builders import build_scene as jax_build_scene
from rtweekend_tpu.render import camera_for_scene as jax_camera_for_scene
from rtweekend_tpu.render import render as jax_render
from rtweekend_tpu_torch.models.builders import build_scene
from rtweekend_tpu_torch.parallel import multihost
from rtweekend_tpu_torch.render import camera_for_scene, render

from test_torch_megakernel import one_torch_thread  # noqa: F401  (autouse)

NAME, SPP, DEPTH, BG = (worker.MULTIHOST_SCENE, worker.MULTIHOST_SPP, worker.MULTIHOST_DEPTH,
                        worker.MULTIHOST_BG)
W = H = worker.W
JOBS = ("multihost_env", "multihost_tcp")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return {job: worker.launch(job, 2, tmp_path_factory.mktemp(job)) for job in JOBS}


@pytest.fixture(scope="module")
def port_fb():
    scene = build_scene(NAME, device="cpu")
    return render(scene, camera_for_scene(NAME, 1.0, "cpu"), W, H, SPP, DEPTH, BG,
                  worker.SEED).numpy()


@pytest.mark.parametrize("job", JOBS)
def test_initialize_joins_the_world(ranks, job):
    for rank, res in enumerate(ranks[job]):
        assert (int(res["world"]), int(res["rank"])) == (2, rank)
        assert str(res["backend"]) == "gloo" and str(res["device"]) == "cpu"


@pytest.mark.parametrize("job", JOBS)
def test_global_mesh(ranks, job):
    for rank, res in enumerate(ranks[job]):
        assert tuple(res["mesh_default"]) == (2, 1)
        assert tuple(res["mesh_samples2"]) == (1, 2)
        assert list(res["coord_samples2"]) == [0, rank]
        assert bool(res["samples3_raises"])


@pytest.mark.parametrize("job", JOBS)
def test_gather_framebuffer_equal_on_every_rank(ranks, job, port_fb):
    r0, r1 = ranks[job]
    assert bool(r0["fb_is_numpy"]) and bool(r1["fb_is_numpy"])
    assert r0["fb"].shape == (H, W, 3)
    np.testing.assert_array_equal(r0["fb"], r1["fb"])
    np.testing.assert_allclose(r0["fb"], port_fb, rtol=1e-4, atol=1e-4)


def test_gathered_framebuffer_matches_jax(ranks):
    want = np.asarray(jax_render(jax_build_scene(NAME),
                                 jax_camera_for_scene(NAME, aspect_ratio=1.0), W, H, SPP,
                                 DEPTH, BG, worker.SEED, rays_per_chunk=1 << 30))
    got = ranks["multihost_tcp"][0]["fb"]
    off = np.abs(got - want) > 1e-3
    assert off.mean() <= 0.005, f"{off.mean():.4f} of lanes off by > 1e-3"
    np.testing.assert_allclose(got.reshape(-1, 3).mean(0), want.reshape(-1, 3).mean(0),
                               rtol=0.02)


def test_gather_framebuffer_is_host_numpy():
    fb = torch.arange(24.0).reshape(2, 4, 3)
    out = multihost.gather_framebuffer(fb)
    assert isinstance(out, np.ndarray)
    np.testing.assert_array_equal(out, fb.numpy())


@pytest.fixture
def recorded(monkeypatch):
    import torch.distributed as dist

    calls = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: calls.append(dict(backend=backend, **kw)))
    return calls


def test_initialize_passthrough(recorded):
    """From the environment: env://, nothing else; from an address:
    tcp://, the world size and the rank. The CPU takes gloo."""
    assert multihost.initialize(device="cpu") == torch.device("cpu")
    multihost.initialize("host0:1234", num_processes=4, process_id=1, device="cpu")
    assert recorded == [
        dict(backend="gloo", init_method="env://"),
        dict(backend="gloo", init_method="tcp://host0:1234", world_size=4, rank=1),
    ]


@pytest.mark.parametrize("args,kw,error", [
    (("host0:1234",), {}, ValueError),                          # no world size or rank
    (("host0:1234", 2, 2), {}, ValueError),                     # rank outside the world
    ((None, 2, 0), {}, ValueError),                             # world size without address
    ((), dict(backend="nccl"), ValueError),                     # NCCL on the CPU
    ((), dict(backend="mpi"), ValueError),                      # not a backend of the port
])
def test_initialize_argument_checks(recorded, args, kw, error):
    with pytest.raises(error):
        multihost.initialize(*args, device="cpu", **kw)
    assert recorded == []


def test_initialize_without_a_card_raises(recorded, monkeypatch):
    """No silent CPU path: without a card, device=None raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.initialize("host0:1234", 2, 0)
    assert recorded == []
