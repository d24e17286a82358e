"""Rendering and inverse rendering over a (tiles, samples) mesh of ranks
(rtweekend_tpu.parallel.shard), on torch.distributed.

A rank's part is a contiguous range of pixel ids (its tile) times a
contiguous range of sample ids (its sample shard); scene parameters are
replicated. The counter RNG keys every draw by (seed, pixel, sample), so
a rank draws exactly the samples the single-device render draws for its
part. What crosses ranks is one SUM all-reduce of the whole image's
per-pixel sums (`_assemble`: each rank writes its part into a zero
buffer; the sum adds a tile's sample shards and places the tiles, and
works alike on NCCL and on gloo, which has no all-gather of card
tensors), and in the train step one SUM all-reduce of the gradients.

- `render_sharded`: each rank traces its part through render's own
  tracer (render.render_range: kernel, compaction, overflow recovery, or
  the eager integrator), then `_assemble` gives every rank the whole
  radiance-sum framebuffer.
- `sharded_train_step`, the JAX package's `_train_step_pallas_streaming`
  (shard.py:413-495) and its use_pallas=False branch:
  - pass 1: the bounce kernel's radiance (or the eager integrator's),
    summed per pixel over sample blocks of at most `rays_per_chunk` rays
    of the rank's part, assembled into the spp-mean image; every rank
    computes the same MSE loss against the target and its cotangent
    2 err / (n_pix * 3);
  - pass 2: per sample block of the rank's part, the kernel's per-bounce
    winners feed the differentiable replay (or the eager trace is
    differentiated end to end, with per-bounce checkpointing), and
    torch.autograd.grad of <cotangent, block sums / spp> is accumulated.
    The block gradients sum to the full gradient because the mean image
    is linear in the blocks, so only one block's winners
    [max_depth, n_pix_l * block] exist at a time. No collective runs
    inside the block loop, so ranks never wait on each other there;
  - the gradients are all-reduced once (one flat buffer), then one SGD
    step: every rank returns the same parameters and loss.
  With mesh=None the step runs on the one device, without collectives.
"""

from __future__ import annotations

import dataclasses
import socket
import time

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from rtweekend_tpu_torch.device import synchronize
from rtweekend_tpu_torch.models.scene import Scene
from rtweekend_tpu_torch.ops import integrator
from rtweekend_tpu_torch.ops.camera import Camera
from rtweekend_tpu_torch.ops.cuda.megakernel import pack_scene, trace_paths
from rtweekend_tpu_torch.ops.cuda.vjp import host_background
from rtweekend_tpu_torch.ops.replay import trace_paths_replay_fast
from rtweekend_tpu_torch.parallel.mesh import SAMPLE_AXIS, TILE_AXIS
from rtweekend_tpu_torch.render import _gen_batch_rays, batch_size, render_range, to_framebuffer


def _mesh_part(mesh: DeviceMesh, width: int, height: int, samples_per_pixel: int):
    """This rank's part on the mesh: ((p0, p1), (s0, s1)), tile t of the
    mesh's T tiles of the pixel ids and sample shard s of its S shards of
    the sample ids, (t, s) = mesh.get_coordinate(). Raises TypeError for
    an object that is not a (tiles, samples) DeviceMesh and ValueError
    when the mesh does not divide the pixels and the spp."""
    if not isinstance(mesh, DeviceMesh) or tuple(mesh.mesh_dim_names or ()) != (
            TILE_AXIS, SAMPLE_AXIS):
        raise TypeError(f"mesh must be a ({TILE_AXIS}, {SAMPLE_AXIS}) DeviceMesh "
                        f"(parallel.mesh.make_mesh), got {type(mesh).__name__}")
    n_t, n_s = mesh.shape
    n_pix = width * height
    if n_pix % n_t or samples_per_pixel % n_s:
        raise ValueError(f"pixels {n_pix} / spp {samples_per_pixel} not divisible by "
                         f"mesh {tuple(mesh.shape)}")
    t, s = mesh.get_coordinate()
    n_pix_l, n_smp_l = n_pix // n_t, samples_per_pixel // n_s
    return (t * n_pix_l, (t + 1) * n_pix_l), (s * n_smp_l, (s + 1) * n_smp_l)


def _assemble(part, pixels, n_pix: int):
    """The whole image's per-pixel sums [n_pix, 3], the same on every
    rank, from every rank's sums [p1 - p0, 3] of its part: one SUM
    all-reduce of a zero buffer holding this rank's part at its pixel ids.
    Adding zeros is exact; only the sum over a tile's sample shards
    reassociates."""
    full = part.new_zeros((n_pix, 3))
    full[pixels[0]:pixels[1]] = part
    dist.all_reduce(full)
    return full


@torch.no_grad()
def render_sharded(scene: Scene, camera: Camera, width: int, height: int,
                   samples_per_pixel: int, max_depth: int, background, seed: int,
                   mesh: DeviceMesh, *, rays_per_chunk: int = 1 << 20, kernel: str = "auto",
                   capacities=None):
    """Render over the mesh; returns the radiance SUM framebuffer [H, W, 3]
    (row 0 at the top), the same on every rank: the single-device
    render's samples (render.render, whose arguments these are), each
    rank tracing its part with render's tracer, then one all-reduce.
    Every rank of the mesh calls it. The default kernel is the card's, as
    in render(); the JAX package's default is its jnp integrator
    (use_pallas=False), which is kernel="eager" here."""
    pixels, samples = _mesh_part(mesh, width, height, samples_per_pixel)
    part = render_range(scene, camera, width, height, pixels, samples, max_depth, background,
                        seed, rays_per_chunk=rays_per_chunk, kernel=kernel,
                        capacities=capacities)
    return to_framebuffer(_assemble(part, pixels, width * height), width, height)


def extract_params(scene: Scene):
    """The differentiable parameter set: sphere centers and radii,
    texture colors (albedo), metal fuzz, dielectric ior."""
    return {
        "c0": scene.spheres.c0,
        "radius": scene.spheres.radius,
        "color": scene.textures.color,
        "fuzz": scene.materials.fuzz,
        "ior": scene.materials.ior,
    }


def merge_params(scene: Scene, params) -> Scene:
    return dataclasses.replace(
        scene,
        spheres=dataclasses.replace(scene.spheres, c0=params["c0"], radius=params["radius"]),
        textures=dataclasses.replace(scene.textures, color=params["color"]),
        materials=dataclasses.replace(scene.materials, fuzz=params["fuzz"], ior=params["ior"]),
    )


def _sample_blocks(camera, width, height, pixels, samples, seed, rays_per_chunk):
    """(block size, block starts, block_rays) over the pixel ids pixels =
    (p0, p1) and the sample ids samples = (s0, s1): block_rays(start)
    makes the rays (origins, dirs, times, pixel_ids, sample_ids) of every
    pixel of the range with samples start .. start + blk - 1, pixel-major."""
    (p0, p1), (s0, s1) = pixels, samples
    blk = batch_size(p1 - p0, s1 - s0, rays_per_chunk)

    def block_rays(start):
        return _gen_batch_rays(camera, seed, start, width=width, height=height, n_samples=blk,
                               pixels=pixels)

    return blk, range(s0, s1, blk), block_rays


@torch.no_grad()
def _pass1_sums(scene: Scene, camera: Camera, width: int, height: int, pixels, samples,
                max_depth: int, background, seed: int, *, kernel: str, rays_per_chunk: int):
    """Per-pixel radiance sums [p1 - p0, 3] of a part: one uncompacted
    launch of the bounce kernel (kernel "auto", "cuda" or "torch") or one
    eager trace (kernel "eager") per sample block."""
    blk, starts, block_rays = _sample_blocks(camera, width, height, pixels, samples, seed,
                                             rays_per_chunk)
    tables = None if kernel == "eager" else pack_scene(scene)
    sums = torch.zeros((pixels[1] - pixels[0], 3), dtype=scene.spheres.c0.dtype,
                       device=scene.device)
    for s0 in starts:
        if tables is None:
            rad = integrator.trace_paths(scene, *block_rays(s0), seed, background, max_depth)
        else:
            rad = trace_paths(tables, *block_rays(s0), seed, host_background(background),
                              max_depth, kernel=kernel)
        sums += rad.reshape(-1, blk, 3).sum(dim=1)
    return sums


def kernel_mean_image(scene: Scene, camera: Camera, width: int, height: int,
                      samples_per_pixel: int, max_depth: int, background, seed: int, *,
                      kernel: str = "auto", rays_per_chunk: int = 1 << 20):
    """The spp-mean radiance [H, W, 3] (row 0 = top) from the bounce
    kernel's own radiance (kernel "auto", "cuda" or "torch"), one launch
    per sample block of at most `rays_per_chunk` rays, or from the eager
    integrator (kernel "eager"): pass 1 of the train step on one device."""
    sums = _pass1_sums(scene, camera, width, height, (0, width * height),
                       (0, samples_per_pixel), max_depth, background, int(seed) & 0xFFFFFFFF,
                       kernel=kernel, rays_per_chunk=rays_per_chunk)
    return to_framebuffer(sums / samples_per_pixel, width, height)


# [rays, primitives] tensors that one bounce of the eager integrator keeps
# for its backward pass while autograd recomputes it (candidate roots,
# masks and the concatenated t), with room for the temporaries beside them
EAGER_WORKSPACES = 16


def eager_rays_per_chunk(scene: Scene, rays_per_chunk: int, ranks_on_card: int = 1) -> int:
    """rays_per_chunk, lowered on a card so that one bounce's backward
    workspaces fit in half of this rank's share of the device memory free
    now, when `ranks_on_card` ranks plan on the same card at once."""
    dev = scene.device
    if dev.type != "cuda":
        return rays_per_chunk
    free, _ = torch.cuda.mem_get_info(dev)
    prims = scene.spheres.radius.shape[0] + scene.rects.k.shape[0]
    per_ray = prims * scene.spheres.c0.element_size() * EAGER_WORKSPACES
    return max(1, min(rays_per_chunk, free // 2 // ranks_on_card // per_ray))


def _ranks_on_card(dev: torch.device) -> int:
    """How many ranks of the default group run on this rank's card (the
    same host and card index): a collective, every rank calls it."""
    here = (socket.gethostname(), dev.index)
    everyone = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, here)
    return everyone.count(here)


def _all_reduce_grads(grads: dict) -> dict:
    """The SUM over ranks of every gradient, by one all-reduce of one flat
    buffer (every gradient has the scene's dtype)."""
    flat = torch.cat([g.reshape(-1) for g in grads.values()])
    dist.all_reduce(flat)
    out, i = {}, 0
    for k, g in grads.items():
        out[k] = flat[i:i + g.numel()].view_as(g)
        i += g.numel()
    return out


def sharded_train_step(scene: Scene, camera: Camera, target, width: int, height: int,
                       samples_per_pixel: int, max_depth: int, background, seed: int,
                       mesh: DeviceMesh | None = None, lr: float = 0.01, *,
                       kernel: str = "auto", rays_per_chunk: int = 1 << 20,
                       use_pallas: bool = True, timings: dict | None = None):
    """One SGD step of inverse rendering. Returns (new params dict, loss as
    a 0-d tensor on the scene's device), the same on every rank.

    mesh: None (one device) or a (tiles, samples) DeviceMesh
    (parallel.mesh.make_mesh) over which every rank calls this with the
    same arguments; it must divide the pixels and the spp (ValueError).
    target [H, W, 3] is the mean-radiance image in framebuffer orientation
    (row 0 = top); it is flipped to pixel-id order (bottom-up rows,
    main.zig:396). The loss is MSE between the spp-mean radiance and the
    target. Gradients equal the full-buffer gradients up to the
    kernel-vs-replay reassociation in the cotangent (the residual is
    taken at the kernel's mean image).

    kernel: "auto", "cuda" or "torch", as in render(). use_pallas=False
    runs the eager integrator in both passes instead, in the scene's dtype,
    with the sample blocks lowered to what the card's free memory holds
    (eager_rays_per_chunk, shared among the ranks on one card); kernel is
    then unused. The default differs from the JAX package's
    (use_pallas=False): the port trains through the kernel path on the
    card. If `timings` is a dict, the device is synchronized between phases
    and it receives the seconds of pass 1 (`pass1_s`) and, on the kernel
    path, of the winners launches (`winners_s`) and of the replay forward
    + backward (`replay_s`), on the eager path of the eager forward +
    backward (`pass2_s`); with a mesh also of the collectives
    (`collective_s`)."""
    dev = scene.device
    dtype = scene.spheres.c0.dtype
    seed = int(seed) & 0xFFFFFFFF
    n_pix = width * height
    if mesh is None:
        pixels, samples = (0, n_pix), (0, samples_per_pixel)
    else:
        pixels, samples = _mesh_part(mesh, width, height, samples_per_pixel)
    clock = ({"pass1_s": 0.0, "winners_s": 0.0, "replay_s": 0.0} if use_pallas
             else {"pass1_s": 0.0, "pass2_s": 0.0})
    if mesh is not None:
        clock["collective_s"] = 0.0

    def tick(key, t0):
        if timings is not None:
            synchronize(dev)
            clock[key] += time.perf_counter() - t0
        return time.perf_counter()

    if timings is not None:
        synchronize(dev)
    t0 = time.perf_counter()
    if not use_pallas:
        kernel = "eager"
        sharing = 1
        if mesh is not None and dev.type == "cuda":
            sharing = _ranks_on_card(dev)
            t0 = tick("collective_s", t0)
        rays_per_chunk = eager_rays_per_chunk(scene, rays_per_chunk, sharing)

    target_flat = torch.flip(torch.as_tensor(target, dtype=dtype, device=dev), [0]).reshape(
        n_pix, 3)
    params = {k: v.detach().requires_grad_(True) for k, v in extract_params(scene).items()}

    # ---- pass 1: loss and cotangent from the tracer's own radiance ----
    sums = _pass1_sums(scene, camera, width, height, pixels, samples, max_depth, background,
                       seed, kernel=kernel, rays_per_chunk=rays_per_chunk)
    t0 = tick("pass1_s", t0)
    if mesh is not None:
        sums = _assemble(sums, pixels, n_pix)
        t0 = tick("collective_s", t0)
    err = sums / samples_per_pixel - target_flat
    loss = torch.sum(err * err) / (n_pix * 3)
    cot = (2.0 * err / (n_pix * 3))[pixels[0]:pixels[1]]

    # ---- pass 2: per block of this rank's part, the VJP of the block's
    # radiance: the replay of the kernel's winners, or the eager trace ----
    blk, starts, block_rays = _sample_blocks(camera, width, height, pixels, samples, seed,
                                             rays_per_chunk)
    if use_pallas:
        with torch.no_grad():
            tables = pack_scene(scene)
    grads = {k: torch.zeros_like(v) for k, v in params.items()}
    for s0 in starts:
        with torch.no_grad():
            o, d, t, pids, sids = block_rays(s0)
        if use_pallas:
            with torch.no_grad():
                _, win = trace_paths(tables, o, d, t, pids, sids, seed,
                                     host_background(background), max_depth, kernel=kernel,
                                     return_winners=True)
            t0 = tick("winners_s", t0)
            rad = trace_paths_replay_fast(merge_params(scene, params), o, d, t, pids, sids,
                                          seed, background, win)
        else:
            rad = integrator.trace_paths(merge_params(scene, params), o, d, t, pids, sids,
                                         seed, background, max_depth, remat=True)
        mean_c = rad.reshape(-1, blk, 3).sum(dim=1) / samples_per_pixel
        # under a flat sky the eager graph never reaches the geometry (a
        # fixed path's radiance is a product of albedos): zero gradients.
        # The replay reads every leaf through its tables, so there a leaf
        # it does not reach is an error
        eager_kw = {} if use_pallas else dict(allow_unused=True, materialize_grads=True)
        g = torch.autograd.grad(torch.sum(cot * mean_c), list(params.values()), **eager_kw)
        for k, gk in zip(params, g):
            grads[k] += gk
        t0 = tick("replay_s" if use_pallas else "pass2_s", t0)
    if mesh is not None:
        grads = _all_reduce_grads(grads)
        t0 = tick("collective_s", t0)

    if timings is not None:
        timings.update(clock)
    new_params = {k: (params[k] - lr * grads[k]).detach() for k in params}
    return new_params, loss
