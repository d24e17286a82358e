"""Gradients through rtweekend_tpu_torch's eager integrator (kernel="eager",
use_pallas=False) against the JAX package's jnp integrator, and against
the port's own kernel-winners replay.

- render_mean(kernel="eager") against JAX render_mean(use_pallas=False):
  one diffuse sphere under the gradient sky (whose geometry gradients are
  nonzero), whose rays all take the same paths on both sides: values and
  gradients at tests/test_torch_grad.py's bars (images rtol 1e-4 / atol
  1e-5, gradients rtol 1e-4 / atol 1e-6).
- sharded_train_step(use_pallas=False) against JAX's on a 1x1 mesh, on
  golden_scene at 12x8, 2 spp, depth 4, lr 1.0, so that p0 - p1 is the
  gradient. As in tests/test_torch_sky_train.py: each side's paths are
  recorded (the JAX side by a jitted copy of its integrator's loop that
  keeps the argmin, the port's by integrator.path_decisions) and at most
  1% of the rays diverge (here 1 of 192: XLA's FMA flips a decision).
  Each side's loss is the MSE of its own mean image; off the diverged
  pixels the images agree within the lane tolerance 1e-3 of
  tests/test_pallas.py (glass amplifies the FMA's last bit to ~1e-4) and
  the loss at rtol 1e-4; the parameters that no diverged pixel's ray
  touched agree at rtol 2e-3 / atol 1e-6, leaving out the rows whose f32
  gradient leaves the f64 one by more than 2.5e-4 relative + 1e-7: at
  most 5% of each group. Through glass, and through the r=1000 ground
  sphere's coefficient rows, whose quadratic cancels terms of ~1e6, the
  f32 gradient of a path can be ill conditioned: a metal's fuzz bends the
  ray that then hits the ground.
- the eager gradient against the replay of the plain bounce version's
  winners, both in the port in float64, on the rays whose paths agree on
  every bounce: relative L2 <= 1e-4 per parameter group.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from rtweekend_tpu.grad import render_mean as jax_render_mean
from rtweekend_tpu.models.builders import build_scene as jax_build_scene
from rtweekend_tpu.models.scene import Diffuse as JDiffuse
from rtweekend_tpu.models.scene import SceneBuilder as JSceneBuilder
from rtweekend_tpu.models.scene import Solid as JSolid
from rtweekend_tpu.ops import intersect as jax_intersect
from rtweekend_tpu.ops.camera import generate_rays as jax_generate_rays
from rtweekend_tpu.ops.camera import make_camera as jax_make_camera
from rtweekend_tpu.ops.integrator import trace_paths as jax_trace_paths
from rtweekend_tpu.ops.scatter import scatter as jax_scatter
from rtweekend_tpu.parallel.mesh import make_mesh
from rtweekend_tpu.parallel.shard import extract_params as jax_extract_params
from rtweekend_tpu.parallel.shard import merge_params as jax_merge_params
from rtweekend_tpu.parallel.shard import sharded_train_step as jax_train_step
from rtweekend_tpu.render import camera_for_scene as jax_camera_for_scene
from rtweekend_tpu_torch.config import SCENE_DEFAULTS
from rtweekend_tpu_torch.convert import params_to_numpy
from rtweekend_tpu_torch.grad import render_mean
from rtweekend_tpu_torch.models.builders import build_scene
from rtweekend_tpu_torch.models.scene import Diffuse, SceneBuilder, Solid
from rtweekend_tpu_torch.ops import integrator
from rtweekend_tpu_torch.ops.camera import batch_rays, make_camera
from rtweekend_tpu_torch.ops.cuda import megakernel as mk
from rtweekend_tpu_torch.ops.replay import trace_paths_replay_fast
from rtweekend_tpu_torch.parallel.shard import extract_params, merge_params, sharded_train_step
from rtweekend_tpu_torch.render import camera_for_scene

from test_torch_megakernel import one_torch_thread  # noqa: F401  (autouse)

NAME = "golden_scene"
SKY = SCENE_DEFAULTS[NAME]["background"]
W, H, SPP, DEPTH, SEED = 12, 8, 2, 4, 43
TARGET = np.random.default_rng(1).uniform(0.2, 0.9, (H, W, 3)).astype(np.float32)


def test_render_mean_eager_grads_match_jax():
    cam_args = ((0, 0, 0), (0, 0, -1), (0, 1, 0), 60.0, 1.0, 0.0, 1.0, 0.0, 1.0)
    jb, b = JSceneBuilder(), SceneBuilder()
    jb.add_sphere((0.1, -0.2, -3.0), 1.0, jb.material(JDiffuse(albedo=JSolid((0.5, 0.3, 0.2)))))
    b.add_sphere((0.1, -0.2, -3.0), 1.0, b.material(Diffuse(albedo=Solid((0.5, 0.3, 0.2)))))
    jscene, scene = jb.build(), b.build("cpu")
    jcam, cam = jax_make_camera(*cam_args), make_camera(*cam_args, device="cpu")
    kw = dict(width=8, height=8, spp=2, max_depth=3)
    target = np.full((8, 8, 3), 0.5, np.float32)

    def jloss(params):
        img = jax_render_mean(jax_merge_params(jscene, params), jcam, SKY, jnp.uint32(SEED),
                              use_pallas=False, **kw)
        return jnp.mean((img - target) ** 2), img

    (want_v, want_img), want = jax.value_and_grad(jloss, has_aux=True)(
        jax_extract_params(jscene))
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in extract_params(scene).items()}
    img = render_mean(merge_params(scene, params), cam, SKY, SEED, kernel="eager", **kw)
    value = torch.mean((img - torch.from_numpy(target)) ** 2)
    got = params_to_numpy(dict(zip(params, torch.autograd.grad(value, list(params.values())))))
    np.testing.assert_allclose(img.detach().numpy(), np.asarray(want_img), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(float(value.detach()), float(want_v), rtol=1e-4)
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    assert np.abs(got["c0"]).sum() > 0 and np.abs(got["radius"]).sum() > 0


_jax_trace = jax.jit(jax_trace_paths, static_argnames=("max_depth",))


@jax.jit
def _jax_winners(scene, o, d, t, pid, sid, seed):
    """[DEPTH, N] closest-hit primitive per bounce of the JAX integrator's
    loop (ops/integrator.trace_paths), -1 for a miss or a dead ray."""
    def bounce(carry, b):
        o, d, alive = carry
        ts = jnp.concatenate([jax_intersect.sphere_candidate_ts(scene, o, d, t, 1e-3),
                              jax_intersect.rect_candidate_ts(scene, o, d, t, 1e-3)], 1)
        idx, tb = jnp.argmin(ts, 1), jnp.min(ts, 1)
        h = jax_intersect.resolve_hit(scene, o, d, t, idx, tb < 5e29, tb)
        sc = jax_scatter(scene, seed, pid, sid, b, d, h)
        win = jnp.where(alive & h.hit, idx, -1)
        alive = alive & h.hit & sc.alive
        o = jnp.where(alive[:, None], h.p, o)
        d = jnp.where(alive[:, None], sc.direction, d)
        return (o, d, alive), win

    _, wins = jax.lax.scan(bounce, (o, d, t == t), jnp.arange(DEPTH, dtype=jnp.int32))
    return wins


def _step_rays():
    """The train step's rays (every pixel, samples 0..SPP-1, pixel-major)
    from the JAX camera, as numpy."""
    cam = jax_camera_for_scene(NAME, aspect_ratio=W / H)
    pid = np.repeat(np.arange(W * H, dtype=np.int32), SPP)
    sid = np.tile(np.arange(SPP, dtype=np.int32), W * H)
    o, d, t = jax_generate_rays(cam, W, H, jnp.asarray(pid), jnp.asarray(sid),
                                jnp.uint32(SEED))
    return [np.array(x) for x in (o, d, t)] + [pid, sid]


def _as_double(x):
    """A copy of a scene (nested dataclasses of tensors) in float64."""
    if isinstance(x, torch.Tensor):
        return x.double() if x.is_floating_point() else x
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(
            x, **{f.name: _as_double(getattr(x, f.name)) for f in dataclasses.fields(x)})
    return x


def _ill_conditioned(scene, rays, img):
    """{parameter: [rows] bool}: the rows (spheres, textures, materials)
    whose gradient of the step's loss (the port's eager trace, the
    cotangent of its own pass-1 image) moves by more than 2.5e-4 relative
    + 1e-7 from f64 to f32."""
    err = (img - TARGET)[::-1].reshape(W * H, 3)
    cot = np.repeat(2.0 * err / (W * H * 3) / SPP, SPP, axis=0)
    grads = []
    for dtype in (torch.float32, torch.float64):
        sc = scene if dtype == torch.float32 else _as_double(scene)
        params = {k: v.detach().clone().requires_grad_(True)
                  for k, v in extract_params(sc).items()}
        r = [torch.from_numpy(x).to(dtype) if x.dtype.kind == "f" else torch.from_numpy(x)
             for x in rays]
        rad = integrator.trace_paths(merge_params(sc, params), *r, SEED, SKY, DEPTH,
                                     remat=True)
        loss = (rad * torch.from_numpy(cot.copy()).to(dtype)).sum()
        g = torch.autograd.grad(loss, list(params.values()))
        grads.append({k: v.double().numpy() for k, v in zip(params, g)})
    ill = {}
    for k, g64 in grads[1].items():
        off = np.abs(grads[0][k] - g64) > 2.5e-4 * np.abs(g64) + 1e-7
        ill[k] = off.reshape(off.shape[0], -1).any(1)
    return ill


def test_eager_train_step_matches_jax():
    jscene = jax_build_scene(NAME)
    jcam = jax_camera_for_scene(NAME, aspect_ratio=W / H)
    mesh = make_mesh((1, 1), jax.devices()[:1])
    jp0 = {k: np.asarray(v) for k, v in jax_extract_params(jscene).items()}
    jp1, jloss = jax_train_step(jscene, jcam, jnp.asarray(TARGET), W, H, SPP, DEPTH,
                                jnp.asarray(SKY, jnp.float32), SEED, mesh, lr=1.0,
                                use_pallas=False)

    scene = build_scene(NAME, device="cpu")
    cam = camera_for_scene(NAME, W / H, "cpu")
    p0 = params_to_numpy(extract_params(scene))
    launches = mk.launch_counts()["launches"]
    tm = {}
    p1, loss = sharded_train_step(scene, cam, torch.from_numpy(TARGET), W, H, SPP, DEPTH,
                                  SKY, SEED, lr=1.0, use_pallas=False, timings=tm)
    p1 = params_to_numpy(p1)
    assert mk.launch_counts()["launches"] == launches and set(tm) == {"pass1_s", "pass2_s"}

    rays = _step_rays()
    j_win = np.asarray(_jax_winners(jscene, *[jnp.asarray(x) for x in rays],
                                    jnp.uint32(SEED)))
    _, p_win = integrator.path_decisions(scene, *[torch.from_numpy(x) for x in rays], SEED,
                                         DEPTH)
    p_win = p_win.numpy()
    diverged = (j_win != p_win).any(0)
    assert diverged.mean() <= 0.01, diverged.mean()
    bad_rays = np.repeat(diverged.reshape(W * H, SPP).any(1), SPP)
    touched = np.concatenate([j_win[:, bad_rays].ravel(), p_win[:, bad_rays].ravel()])
    spheres = np.unique(touched[(touched >= 0) & (touched < scene.spheres.radius.shape[0])])
    mats = np.unique(scene.spheres.mat_id.numpy()[spheres])
    texs = np.unique(scene.materials.tex_id.numpy()[mats])

    # pass 1: each side's loss is the MSE of its own mean image, and the
    # images and the loss agree off the diverged pixels
    rad = integrator.trace_paths(scene, *[torch.from_numpy(x) for x in rays], SEED, SKY,
                                 DEPTH).numpy()
    j_rad = np.asarray(_jax_trace(jscene, *[jnp.asarray(x) for x in rays], jnp.uint32(SEED),
                                  jnp.asarray(SKY, jnp.float32), max_depth=DEPTH))
    img, j_img = (r.reshape(H, W, SPP, 3).mean(2)[::-1] for r in (rad, j_rad))
    np.testing.assert_allclose(float(jloss), ((j_img - TARGET) ** 2).mean(), rtol=1e-5)
    np.testing.assert_allclose(float(loss), ((img - TARGET) ** 2).mean(), rtol=1e-5)
    good = ~bad_rays.reshape(W * H, SPP)[:, 0].reshape(H, W)[::-1]
    np.testing.assert_allclose(img[good], j_img[good], rtol=0, atol=1e-3)
    np.testing.assert_allclose(((img - TARGET)[good] ** 2).mean(),
                               ((j_img - TARGET)[good] ** 2).mean(), rtol=1e-4)

    ill = _ill_conditioned(scene, rays, img)
    assert ill["c0"].sum() <= 0.05 * scene.spheres.active.sum().item()
    for k in ("color", "fuzz", "ior"):
        assert ill[k].sum() <= max(1, 0.05 * ill[k].shape[0]), (k, np.nonzero(ill[k])[0])
    touched_by = {"c0": spheres, "radius": spheres, "color": texs, "fuzz": mats, "ior": mats}
    touched_by = {k: np.union1d(v, np.nonzero(ill[k])[0]) for k, v in touched_by.items()}
    for k in jp0:
        np.testing.assert_array_equal(p0[k], jp0[k])
        want = jp0[k] - np.asarray(jp1[k])
        got = p0[k] - p1[k]
        assert np.isfinite(got).all(), k
        keep = np.ones(got.shape[0], dtype=bool)
        keep[touched_by[k]] = False
        np.testing.assert_allclose(got[keep], want[keep], rtol=2e-3, atol=1e-6, err_msg=k)
        if k in ("c0", "radius", "color"):
            assert np.abs(want).sum() > 0.0 and np.abs(got).sum() > 0.0, k


def _rel_l2(a, b):
    nb = torch.linalg.norm(b.double())
    return float(torch.linalg.norm((a - b).double()) / nb) if nb > 0 else float(
        torch.linalg.norm((a - b).double()))


def test_eager_grads_match_the_kernel_winners_replay():
    """In float64, where both are accurate: through glass and the r=1000
    ground sphere the float32 gradient of a path is ill conditioned, and
    the eager march's coefficient form and the replay's direct form round
    differently (float32 relative L2 of 4.6 for c0 here, 3e-9 in float64).
    A float32 Schlick draw can also flip on a ray whose winners stay the
    same (both branches leave the scene)."""
    w, h, spp = 24, 16, 2
    scene = build_scene(NAME, device="cpu", dtype=torch.float64)
    cam = camera_for_scene(NAME, w / h, "cpu", torch.float64)
    rays = batch_rays(cam, SEED, 0, width=w, height=h, n_samples=spp)
    _, e_win = integrator.path_decisions(scene, *rays, SEED, DEPTH)
    cam32 = camera_for_scene(NAME, w / h, "cpu")
    _, k_win = mk.trace_paths(mk.pack_scene(build_scene(NAME, device="cpu")),
                              *batch_rays(cam32, SEED, 0, width=w, height=h, n_samples=spp),
                              SEED, SKY, DEPTH, kernel="torch", return_winners=True)
    same = (e_win == k_win).all(0)
    assert same.double().mean() >= 0.99

    def grads(trace):
        params = {k: v.detach().clone().requires_grad_(True)
                  for k, v in extract_params(scene).items()}
        rad = trace(merge_params(scene, params))
        loss = (((rad - 0.5) ** 2).sum(1) * same).sum() / rad.shape[0]
        return dict(zip(params, torch.autograd.grad(loss, list(params.values()))))

    eager = grads(lambda sc: integrator.trace_paths(sc, *rays, SEED, SKY, DEPTH, remat=True))
    replay = grads(lambda sc: trace_paths_replay_fast(sc, *rays, SEED, SKY, k_win))
    for k in eager:
        assert torch.isfinite(eager[k]).all(), k
        assert _rel_l2(eager[k], replay[k]) <= 1e-4, (k, _rel_l2(eager[k], replay[k]))
    for k in ("c0", "radius", "color"):
        assert eager[k].abs().sum() > 0, k
