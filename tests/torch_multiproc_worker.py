"""One rank of the port's multi-process tests (tests/test_torch_multidevice.py,
tests/test_torch_multihost.py): gloo on the CPU, one OS process a rank,
joined through rtweekend_tpu_torch.parallel.multihost.initialize. Imports
no JAX. Writes its results to <out_dir>/rank<rank>.npz.

Usage: python torch_multiproc_worker.py <job> <world> <rank> <port> <out_dir>
(or `launch`, from the tests).

job: "multidevice" (render_sharded and sharded_train_step on every mesh
of the world's size that tests/test_sharding.py uses), "multihost_tcp"
(initialize from an explicit tcp:// address) or "multihost_env"
(initialize from MASTER_ADDR/MASTER_PORT/RANK/WORLD_SIZE).
"""

import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# the sizes of tests/test_sharding.py
W = H = 16
SPP = 4
DEPTH = 3
SEED, TRAIN_SEED = 42, 43
MULTIHOST_SCENE, MULTIHOST_SPP, MULTIHOST_DEPTH = "two_spheres", 2, 2
MULTIHOST_BG = (0.7, 0.8, 1.0)
# rays_per_chunk of __graft_entry__.dryrun_multichip: at mesh (2, 2) a rank
# holds 128 pixels x 2 samples, so one sample a block: two winner blocks
DRYRUN_CHUNK = 64


# seconds a launch may take before every rank is killed (each takes a few)
TIMEOUT_S = 240


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def launch(job, world, out_dir):
    """Run `job` on `world` ranks, one process each, on a free localhost
    port (given to "multihost_env" in torchrun's variables, to the other
    jobs as an argument); returns every rank's results (dicts of numpy arrays, by rank).
    A rank that fails, or a launch that outlasts TIMEOUT_S (every rank is
    then killed, so a hang cannot stall the suite), raises AssertionError
    with the ranks' output."""
    import numpy as np

    port = free_port()
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    for k in ("XLA_FLAGS", "MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK"):
        env.pop(k, None)
    procs = []
    for rank in range(world):
        rank_env = env
        if job == "multihost_env":
            rank_env = {**env, "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
                        "RANK": str(rank), "WORLD_SIZE": str(world), "LOCAL_RANK": str(rank)}
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), job, str(world), str(rank), str(port),
             str(out_dir)], cwd=REPO, env=rank_env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT))
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=TIMEOUT_S)
            logs.append(out.decode(errors="replace")[-3000:])
    except subprocess.TimeoutExpired:
        raise AssertionError(f"{job}: a rank of {world} hung past {TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"{job} rank {rank}: rc {p.returncode}\n{log}"
    results = []
    for rank in range(world):
        with np.load(os.path.join(out_dir, f"rank{rank}.npz")) as z:
            results.append({k: z[k] for k in z.files})
    return results


def meshes(world):
    return {4: ((4, 1), (2, 2), (1, 4)), 1: ((1, 1),)}[world]


def _train_results(res, tag, scene, cam, target, mesh, **kw):
    from rtweekend_tpu_torch.parallel import shard

    params, loss = shard.sharded_train_step(scene, cam, target, W, H, SPP, DEPTH,
                                            (0.0, 0.0, 0.0), TRAIN_SEED, mesh, lr=1.0, **kw)
    res[f"{tag}_loss"] = loss.numpy()
    for k, v in params.items():
        res[f"{tag}_{k}"] = v.numpy()


def multidevice(world, res):
    from rtweekend_tpu_torch.models.builders import build_scene
    from rtweekend_tpu_torch.parallel import shard
    from rtweekend_tpu_torch.parallel.mesh import make_mesh
    from rtweekend_tpu_torch.render import camera_for_scene, render

    scene = build_scene("simple_light", device="cpu")
    cam = camera_for_scene("simple_light", 1.0, "cpu")
    bg = (0.0, 0.0, 0.0)
    target = render(scene, cam, W, H, SPP, DEPTH, bg, SEED) / SPP
    for shape in meshes(world):
        mesh = make_mesh(shape, device="cpu")
        tag = f"{shape[0]}x{shape[1]}"
        res[f"render_{tag}"] = shard.render_sharded(scene, cam, W, H, SPP, DEPTH, bg, SEED,
                                                    mesh).numpy()
        res[f"coord_{tag}"] = list(mesh.get_coordinate())
        _train_results(res, f"train_{tag}", scene, cam, target, mesh)
    if world == 1:
        return
    mesh = make_mesh((2, 2), device="cpu")
    res["render_eager_2x2"] = shard.render_sharded(scene, cam, W, H, SPP, DEPTH, bg, SEED, mesh,
                                                   kernel="eager").numpy()
    _train_results(res, "train_eager_2x2", scene, cam, target, mesh, use_pallas=False)
    real, winner_blocks = shard.trace_paths, []

    def counted(*a, **kw):
        winner_blocks.append(bool(kw.get("return_winners")))
        return real(*a, **kw)

    shard.trace_paths = counted
    _train_results(res, "train_dryrun_2x2", scene, cam, target, mesh,
                   rays_per_chunk=DRYRUN_CHUNK)
    shard.trace_paths = real
    res["dryrun_winner_blocks"] = sum(winner_blocks)
    try:
        shard.render_sharded(scene, cam, 15, 15, SPP, DEPTH, bg, SEED, make_mesh(device="cpu"))
        res["indivisible_raises"] = False
    except ValueError:
        res["indivisible_raises"] = True


def multihost(res):
    from rtweekend_tpu_torch.models.builders import build_scene
    from rtweekend_tpu_torch.parallel import multihost as mh
    from rtweekend_tpu_torch.parallel.shard import render_sharded
    from rtweekend_tpu_torch.render import camera_for_scene

    m1 = mh.global_mesh(device="cpu")
    m2 = mh.global_mesh(samples_axis=2, device="cpu")
    res["mesh_default"], res["mesh_samples2"] = tuple(m1.shape), tuple(m2.shape)
    res["coord_samples2"] = list(m2.get_coordinate())
    try:
        mh.global_mesh(samples_axis=3, device="cpu")
        res["samples3_raises"] = False
    except ValueError as e:
        res["samples3_raises"] = "not divisible" in str(e)
    scene = build_scene(MULTIHOST_SCENE, device="cpu")
    cam = camera_for_scene(MULTIHOST_SCENE, 1.0, "cpu")
    fb = render_sharded(scene, cam, W, H, MULTIHOST_SPP, MULTIHOST_DEPTH, MULTIHOST_BG, SEED, m1)
    full = mh.gather_framebuffer(fb)
    res["fb_is_numpy"] = type(full).__module__ == "numpy"
    res["fb"] = full


def main() -> int:
    job, world, rank, port, out_dir = sys.argv[1:6]
    world, rank = int(world), int(rank)

    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from rtweekend_tpu_torch.parallel import multihost as mh

    if job == "multihost_env":
        dev = mh.initialize(device="cpu")
    else:
        dev = mh.initialize(f"127.0.0.1:{port}", world, rank, device="cpu")
    res = dict(world=dist.get_world_size(), rank=dist.get_rank(), backend=dist.get_backend(),
               device=str(dev))
    try:
        if job == "multidevice":
            multidevice(world, res)
        else:
            multihost(res)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
