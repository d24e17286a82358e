"""Render driver: sample-batched accumulation into a framebuffer.

The reference's rows/cols/samples loop (reference src/main.zig:382-402)
becomes: generate every pixel's rays for a batch of samples at once,
trace them as one wavefront, and add the per-pixel radiance sums, in
pixel-id order, into a buffer on the device that becomes the framebuffer
once, at the end. `render_range` does this for a range of pixel ids and
of sample ids, which is how each rank of parallel/shard.render_sharded
traces its part. Two tracers:

- the bounce kernel (kernel "cuda", or its plain version "torch"; "auto"
  picks the kernel on the card), float32, through the compacted driver.
  Nothing is read back to the host until the end of the render, where the
  overflow flags of all batches are read once and any overflowed batch is
  traced again uncompacted (`_Tracer.recover`). render_image derives
  the compaction schedule from a measured alive-fraction probe of the
  scene (`adaptive_capacities`);
- the eager integrator (kernel "eager": ops/integrator.trace_paths, no
  compaction) in the scene's dtype, float32 or float64. "auto" picks it
  for a float64 scene, which the kernel does not run.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from rtweekend_tpu_torch.config import (
    FOCUS_DIST,
    SCENE_DEFAULTS,
    TIME0,
    TIME1,
    VUP,
    RenderConfig,
    torch_dtype,
)
from rtweekend_tpu_torch.device import resolve_device
from rtweekend_tpu_torch.models.builders import build_scene
from rtweekend_tpu_torch.models.scene import Scene
from rtweekend_tpu_torch.ops import integrator
from rtweekend_tpu_torch.ops.camera import Camera, batch_rays, generate_rays, make_camera
from rtweekend_tpu_torch.ops.cuda.megakernel import (
    CAPS_CLOSED,
    CAPS_OPEN,
    KERNELS,
    LAUNCHES,
    camera_floats,
    pack_scene,
    ray_state,
    state_rays,
    trace_paths,
    trace_paths_compact,
)
from rtweekend_tpu_torch.utils import image as image_mod
from rtweekend_tpu_torch.utils.profiling import alive_fractions

# kernel choices of the render entry points: the bounce kernel's, and the
# eager integrator
RENDER_KERNELS = KERNELS + ("eager",)


def resolve_kernel(kernel: str, dtype: torch.dtype) -> str:
    """The tracer a render in `dtype` runs for a kernel choice. float64
    runs on the eager integrator only: "auto" picks it, and "cuda" or
    "torch" (the float32 bounce kernel and its plain version) raise rather
    than downcast."""
    if kernel not in RENDER_KERNELS:
        raise ValueError(f"kernel must be one of {RENDER_KERNELS}, got {kernel!r}")
    if torch_dtype(dtype) == torch.float64:
        if kernel in ("cuda", "torch"):
            raise ValueError(
                f"kernel={kernel!r} is float32 only; a float64 render runs on the eager "
                "integrator (kernel='eager' or 'auto')")
        return "eager"
    return kernel


def _pixel_sums(radiance, n_samples: int):
    """Per-pixel sums [n_pix, 3] of a pixel-major batch's radiance."""
    return radiance.reshape(-1, n_samples, 3).sum(dim=1)


def to_framebuffer(sums, width: int, height: int):
    """Per-pixel sums [W * H, 3] in pixel-id order (bottom-up rows) as a
    framebuffer [H, W, 3] with row 0 at the top."""
    return sums.reshape(height, width, 3).flip(0)


def _capacities_for(background):
    """Static compaction schedule from the (host-side) background: a lit
    background means rays escape and die fast (open scenes); a black one
    means an enclosed emissive scene where most rays stay alive."""
    return CAPS_OPEN if float(np.max(background)) > 0.0 else CAPS_CLOSED


def probe_fractions(scene_name: str, max_depth: int, *, probe_width: int = 64,
                    probe_spp: int = 2, seed: int = 0):
    """adaptive_capacities's probe: the alive fraction entering each bounce
    (a list of max_depth floats) of a probe_width^2 x probe_spp wavefront
    through the scene's square camera, on the CPU."""
    scene = build_scene(scene_name, device="cpu")
    camera = camera_for_scene(scene_name, aspect_ratio=1.0, device="cpu")
    n_pix = probe_width * probe_width
    pids = torch.arange(n_pix, dtype=torch.int32).repeat_interleave(probe_spp)
    sids = torch.arange(probe_spp, dtype=torch.int32).repeat(n_pix)
    o, d, t = generate_rays(camera, probe_width, probe_width, pids, sids, seed)
    return alive_fractions(scene, o, d, t, pids, sids, seed, max_depth).tolist()


# (scene, depth, lit background, probe settings) -> schedule
_ADAPTIVE_CAPS_CACHE: dict = {}


def adaptive_capacities(scene_name: str, background, max_depth: int, *,
                        margin: float = 2.5, max_boundaries: int = 4,
                        boundary_penalty: float = 0.5, min_frac: float = 0.004,
                        probe_width: int = 64, probe_spp: int = 2, seed: int = 0):
    """Measured compaction schedule (rtweekend_tpu.render.adaptive_capacities):
    probe the per-bounce alive fractions of a probe_width^2 x probe_spp
    wavefront of the scene with the eager integrator, then place at most
    `max_boundaries` shrink points with a `margin`x safety factor.

    The probe runs on the CPU, whatever device renders: the schedule is a
    function of the scene's name, built anew on the host, and the JAX
    package computes it there too. Alive fractions never grow (rays do not
    resurrect), so a boundary's capacity covers its whole segment. Cached
    per scene, depth, lit background and probe settings."""
    lit = float(np.max(background)) > 0.0
    key = (scene_name, max_depth, lit, margin, max_boundaries, boundary_penalty, min_frac,
           probe_width, probe_spp, seed)
    if key in _ADAPTIVE_CAPS_CACHE:
        return _ADAPTIVE_CAPS_CACHE[key]

    fracs = probe_fractions(scene_name, max_depth, probe_width=probe_width,
                            probe_spp=probe_spp, seed=seed)

    # Exact DP: at most max_boundaries shrink points minimizing the executed
    # lane-bounces sum(cap(seg) * len(seg)) plus a per-boundary penalty (in
    # full-buffer-bounce units: every boundary is one more launch and one
    # more compaction gather). need[b] is the margin'd capacity a boundary
    # at b would set.
    need = [1.0] + [max(min(margin * float(fracs[b]), 1.0), min_frac)
                    for b in range(1, max_depth)]
    best = {}  # (j, k) -> (cost, schedule from j)

    def solve(j, cap, k):
        if j >= max_depth:
            return 0.0, ()
        if (j, k) in best:
            return best[(j, k)]
        cost, sched = cap * (max_depth - j), ()
        if k > 0:
            for m in range(j + 1, max_depth):
                if need[m] >= cap:
                    continue
                sub, ssched = solve(m, need[m], k - 1)
                c = cap * (m - j) + boundary_penalty + sub
                if c < cost:
                    cost, sched = c, ((m, need[m]),) + ssched
        best[(j, k)] = (cost, sched)
        return cost, sched

    # memoizing on (j, k) holds: the cap at a boundary j > 0 is always
    # need[j], and j = 0 (cap 1.0) is only the root call
    _, sched = solve(0, 1.0, max_boundaries)
    _ADAPTIVE_CAPS_CACHE[key] = tuple(sched)
    return _ADAPTIVE_CAPS_CACHE[key]


def batch_size(n_pix: int, samples_per_pixel: int, rays_per_chunk: int) -> int:
    """Samples a batch (of a render, or a block of a train step): the
    largest divisor of spp with n_pix * batch rays within rays_per_chunk,
    at least 1 (one batch shape for the whole render)."""
    batch = max(1, min(samples_per_pixel, rays_per_chunk // max(n_pix, 1)))
    while batch > 1 and samples_per_pixel % batch:
        batch -= 1
    return batch


class _Tracer:
    """A render's sample batches over the pixel-id range `pixels` (default:
    the whole image) on one tracer: `batch(start, n, sums)` adds samples
    start .. start + n - 1 of every pixel of the range into the per-pixel
    sums [n_pix, 3] (pixel-id order), and `recover(sums)` re-traces the
    kernel batches whose compaction overflowed since the last call: their
    compacted contribution (deterministic, counter-keyed) is subtracted and
    the batch traced again without compaction, which never drops rays,
    inside an "overflow_retrace" profiler span and counted by
    megakernel.LAUNCHES["retrace_launches"]. The flags are read once, in
    recover; the kernel path's batches make their state with ray_state,
    from the camera's values read once here, so a batch never waits on the
    device."""

    def __init__(self, scene, camera, width, height, max_depth, background, seed,
                 kernel, capacities, pixels=None):
        self.ray_kw = dict(width=width, height=height, pixels=pixels)
        p0, p1 = (0, width * height) if pixels is None else pixels
        self.n_pix = p1 - p0
        self.scene, self.camera, self.background, self.seed = scene, camera, background, seed
        self.max_depth = max_depth
        self.kernel = kernel
        self.eager = kernel == "eager"
        self.tables = None if self.eager else pack_scene(scene)
        self.host_camera = None if self.eager else camera_floats(camera)
        self.capacities = capacities
        self.overflows = []  # [(sample_start, n_samples, device flag)]

    def _state(self, start, n):
        return ray_state(self.camera, self.seed, start, n_samples=n,
                         host_camera=self.host_camera, kernel=self.kernel, **self.ray_kw)

    def _compact(self, state, n):
        return trace_paths_compact(self.tables, state, self.n_pix * n, self.seed,
                                   self.background, self.max_depth,
                                   capacities=self.capacities, kernel=self.kernel)

    def batch(self, start, n, sums):
        if self.eager:
            rays = batch_rays(self.camera, self.seed, start, n_samples=n, **self.ray_kw)
            rad = integrator.trace_paths(self.scene, *rays, self.seed, self.background,
                                         self.max_depth)
        else:
            rad, ovf = self._compact(self._state(start, n), n)
            self.overflows.append((start, n, ovf))
        sums += _pixel_sums(rad, n)
        return sums

    def recover(self, sums):
        if not self.overflows:
            return sums
        flags = torch.stack([f for _, _, f in self.overflows]).cpu()
        for (start, n, _), bad in zip(self.overflows, flags.tolist()):
            if not bad:
                continue
            with torch.profiler.record_function("overflow_retrace"):
                state = self._state(start, n)
                wrong, _ = self._compact(state, n)
                good = trace_paths(self.tables, *state_rays(state, self.n_pix * n), self.seed,
                                   self.background, self.max_depth, kernel=self.kernel)
                sums = sums - _pixel_sums(wrong, n) + _pixel_sums(good, n)
            LAUNCHES["retrace_launches"] += 1
        self.overflows = []
        return sums


@torch.no_grad()
def render_range(scene: Scene, camera: Camera, width: int, height: int, pixels, samples,
                 max_depth: int, background, seed: int, *, rays_per_chunk: int = 1 << 20,
                 kernel: str = "auto", capacities=None, progress: bool = False,
                 metrics=None):
    """Per-pixel radiance sums [p1 - p0, 3], in pixel-id order (bottom-up
    rows), of the pixel ids pixels = (p0, p1) over the sample ids
    samples = (s0, s1): render()'s tracing (sample batches of at most
    rays_per_chunk rays, compaction, overflow recovery) for one part of
    an image. render() runs it over the whole image; each rank of
    parallel/shard.render_sharded over its own part. The counter RNG keys
    every draw by (seed, pixel, sample), so a part's draws are the whole
    render's. Arguments as in render(); metrics receives a
    batch_submitted event a batch."""
    dtype = scene.spheres.c0.dtype
    kernel = resolve_kernel(kernel, dtype)
    if capacities is None:
        capacities = _capacities_for(background)
    seed = int(seed) & 0xFFFFFFFF
    (p0, p1), (s0, s1) = pixels, samples
    batch = batch_size(p1 - p0, s1 - s0, rays_per_chunk)
    tracer = _Tracer(scene, camera, width, height, max_depth, background, seed, kernel,
                     capacities, pixels=(p0, p1))
    sums = torch.zeros((p1 - p0, 3), dtype=dtype, device=scene.device)
    done = s0
    while done < s1:
        n = min(batch, s1 - done)
        sums = tracer.batch(done, n, sums)
        done += n
        if metrics is not None:
            metrics.log("batch_submitted", samples_done=done - s0, spp=s1 - s0)
        if progress:
            print(f"\rsamples: {done - s0}/{s1 - s0}   ", end="", flush=True)
    if progress:
        print()
    return tracer.recover(sums)


@torch.no_grad()
def render(scene: Scene, camera: Camera, width: int, height: int,
           samples_per_pixel: int, max_depth: int, background, seed: int, *,
           rays_per_chunk: int = 1 << 20, kernel: str = "auto", capacities=None,
           progress: bool = False, metrics=None):
    """Full render on the scene's device; returns the radiance SUM
    framebuffer [H, W, 3] in the scene's dtype (divide by spp / tone map
    downstream).

    background is a host value: 3 floats (flat sky) or a (bottom, top)
    pair (the gradient sky, lerped by ray elevation). kernel: "auto" (the
    CUDA kernel for a float32 scene on the card, its plain version on the
    CPU, the eager integrator for a float64 scene), "cuda", "torch" (the
    plain version) or "eager" (the eager integrator, no compaction).
    capacities overrides the kernel path's compaction schedule (sequence of
    (bounce, fraction); () disables compaction); by default it follows the
    background. metrics: an optional utils.metrics.MetricsLogger, which
    receives render_start, batch_submitted and render_done events."""
    n_pix = width * height
    if metrics is not None:
        metrics.log("render_start", width=width, height=height, spp=samples_per_pixel,
                    max_depth=max_depth,
                    batch=batch_size(n_pix, samples_per_pixel, rays_per_chunk),
                    use_pallas=resolve_kernel(kernel, scene.spheres.c0.dtype) != "eager",
                    n_devices=1, backend=scene.device.type)
    t_start = time.perf_counter()
    sums = render_range(scene, camera, width, height, (0, n_pix), (0, samples_per_pixel),
                        max_depth, background, seed, rays_per_chunk=rays_per_chunk,
                        kernel=kernel, capacities=capacities, progress=progress,
                        metrics=metrics)
    accum = to_framebuffer(sums, width, height)
    if metrics is not None:
        if accum.device.type == "cuda":
            torch.cuda.synchronize(accum.device)
        wall = time.perf_counter() - t_start
        n_rays = n_pix * samples_per_pixel
        metrics.log("render_done", wall_s=round(wall, 4), rays_per_s=round(n_rays / wall),
                    rays_per_s_per_device=round(n_rays / wall), spp=samples_per_pixel)
    return accum


def camera_for_scene(name: str, aspect_ratio=None, device=None,
                     dtype=torch.float32) -> Camera:
    p = SCENE_DEFAULTS[name]
    aspect = aspect_ratio if aspect_ratio is not None else p["width"] / p["height"]
    return make_camera(
        p["look_from"], p["look_at"], VUP, p["vfov"], aspect, p["aperture"],
        p.get("focus_dist", FOCUS_DIST), TIME0, TIME1,
        device=resolve_device(device), dtype=dtype,
    )


def render_image(config: RenderConfig, *, device=None, kernel: str = "auto",
                 capacities=None, progress: bool = False, metrics=None):
    """End to end: build scene and camera from config in its dtype on
    `device` (default: the card), render, tone map. On the kernel path,
    without capacities given, the compaction schedule is the scene's
    adaptive_capacities. Returns (uint8 image [H, W, 3] numpy,
    radiance-sum framebuffer tensor)."""
    dev = resolve_device(device)
    dtype = config.torch_dtype
    kernel = resolve_kernel(kernel, dtype)
    scene = build_scene(config.scene, seed=config.seed, device=dev, dtype=dtype)
    camera = camera_for_scene(config.scene, config.width / config.height, dev, dtype)
    background = SCENE_DEFAULTS[config.scene]["background"]
    if capacities is None and kernel != "eager":
        capacities = adaptive_capacities(config.scene, background, config.max_depth)
    accum = render(
        scene, camera, config.width, config.height, config.samples_per_pixel,
        config.max_depth, background, config.seed,
        rays_per_chunk=config.rays_per_chunk, kernel=kernel,
        capacities=capacities, progress=progress, metrics=metrics,
    )
    img = image_mod.tonemap(accum, config.samples_per_pixel)
    return img.cpu().numpy(), accum
