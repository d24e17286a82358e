"""The training path under the gradient sky: rtweekend_tpu_torch's
sharded_train_step on golden_scene (winners of the sky variant, then the
replay) against the JAX package's sharded_train_step on a 1x1 mesh with
use_pallas=True (the Pallas kernel in interpret mode), at 12x8, 2 spp,
depth 4, lr 1.0, so that p0 - p1 is the gradient.

Under a flat sky the geometry gradients of a fixed path are exactly zero
(its radiance is a product of albedos); the gradient sky makes c0 and
radius matter, so both sides must give them nonzero, and agree.

golden_scene has glass: a last-bit difference between the two kernels'
candidate t can send a ray down another path (here 1 ray of the 192
takes an internal reflection on one side and leaves the sphere on the
other), and that ray's pixel then has another mean, another residual and
another contribution to every parameter its rays touch. So the two
sides are held to each other everywhere else, with the bars
tests/test_torch_train.py holds the flat-sky step to
(tests/test_sharding.py:167-221), and the diverged rays are counted:
- at most 1% of the rays diverge (winners differ on some bounce);
- the per-pixel mean radiance of pass 1 on the pixels without a
  diverged ray: within the lane tolerance 1e-3 of tests/test_pallas.py
  on every such pixel (f32 reassociation along the same paths; glass
  amplifies it to ~1e-4), and each side's loss is the MSE of its own
  mean image (rtol 1e-5);
- gradient entries of the materials and textures that no ray of those
  pixels touched: rtol 2e-3 / atol 1e-6 (albedo, fuzz, ior);
- sphere centers and radii: rtol 2e-3 / atol 1e-6 too, on the spheres
  that no such ray touched and whose gradient is well conditioned in
  f32. Through glass (golden_scene has 24 glass spheres) a path's
  d radiance / d (center, radius) can be ill conditioned: here four rays
  of the 192, each refracted through 2-3 glass spheres, have c0
  gradients whose f32 value differs from the same replay's f64 value by
  1-10%, on both sides alike (measured: the JAX and the port f32
  gradient of one such ray are 17% and 10% from the f64 one). So the
  port's replay of the step's loss on its own winners is run in f32 and
  in f64, and a sphere whose f32 center or radius gradient leaves its f64
  value by more than an eighth of the bar (2.5e-4 relative + 1e-7) is
  left out; at most 5% of the scene's spheres may be (15 of 487 here).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from rtweekend_tpu.models.builders import build_scene as jax_build_scene
from rtweekend_tpu.ops.camera import generate_rays as jax_generate_rays
from rtweekend_tpu.ops.pallas.megakernel import trace_paths_pallas
from rtweekend_tpu.parallel.mesh import make_mesh
from rtweekend_tpu.parallel.shard import extract_params as jax_extract_params
from rtweekend_tpu.parallel.shard import sharded_train_step as jax_train_step
from rtweekend_tpu.render import camera_for_scene as jax_camera_for_scene
from rtweekend_tpu_torch.config import SCENE_DEFAULTS
from rtweekend_tpu_torch.convert import params_to_numpy
from rtweekend_tpu_torch.models.builders import build_scene
from rtweekend_tpu_torch.ops.cuda import megakernel as mk
from rtweekend_tpu_torch.ops.replay import trace_paths_replay_fast
from rtweekend_tpu_torch.parallel.shard import extract_params, merge_params, sharded_train_step
from rtweekend_tpu_torch.render import camera_for_scene

from test_torch_megakernel import one_torch_thread  # noqa: F401  (autouse)

NAME = "golden_scene"
W, H = 12, 8
SPP = 2
DEPTH = 4
SEED = 43
BG = SCENE_DEFAULTS[NAME]["background"]
TARGET = np.random.default_rng(1).uniform(0.2, 0.9, (H, W, 3)).astype(np.float32)


def _paths(jax_scene, jax_cam):
    """Both sides' pass-1 radiance [N, 3] and winners [DEPTH, N] on the
    step's rays (every pixel, samples 0..SPP-1, pixel-major)."""
    pid = jnp.repeat(jnp.arange(W * H, dtype=jnp.int32), SPP)
    sid = jnp.tile(jnp.arange(SPP, dtype=jnp.int32), W * H)
    o, d, t = jax_generate_rays(jax_cam, W, H, pid, sid, jnp.uint32(SEED))
    j_rad, j_win = trace_paths_pallas(jax_scene, o, d, t, pid, sid, jnp.uint32(SEED),
                                      jnp.asarray(BG, jnp.float32), DEPTH, interpret=True,
                                      return_winners=True)
    rays = [torch.from_numpy(np.array(x)) for x in (o, d, t, pid, sid)]
    tables = mk.pack_scene(build_scene(NAME, device="cpu"))
    p_rad, p_win = mk.trace_paths(tables, *rays, SEED, BG, DEPTH, return_winners=True)
    return np.asarray(j_rad), np.asarray(j_win), p_rad.numpy(), p_win.numpy(), rays


def _image(rad):
    """Per-ray radiance -> spp-mean image [H, W, 3], row 0 = top."""
    return rad.reshape(H, W, SPP, 3).mean(2)[::-1]


def _as_double(x):
    """A copy of a scene (nested dataclasses of tensors) in float64."""
    if isinstance(x, torch.Tensor):
        return x.double() if x.is_floating_point() else x
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(
            x, **{f.name: _as_double(getattr(x, f.name)) for f in dataclasses.fields(x)})
    return x


def _ill_conditioned(pscene, rays, win, p_img):
    """[S] bool: spheres whose center or radius gradient of the step's loss
    (the port's replay on its own winners, the cotangent of its own pass-1
    image) moves by more than 2.5e-4 relative + 1e-7 from f64 to f32."""
    err = (p_img - TARGET)[::-1].reshape(W * H, 3)
    cot = np.repeat(2.0 * err / (W * H * 3) / SPP, SPP, axis=0)
    grads = []
    for dtype in (torch.float32, torch.float64):
        scene = pscene if dtype == torch.float32 else _as_double(pscene)
        params = {k: v.detach().clone().requires_grad_(True)
                  for k, v in extract_params(scene).items()}
        r = [x.to(dtype) if x.is_floating_point() else x for x in rays]
        rad = trace_paths_replay_fast(merge_params(scene, params), *r, SEED, BG,
                                      torch.from_numpy(win))
        loss = (rad * torch.from_numpy(cot.copy()).to(dtype)).sum()
        g = torch.autograd.grad(loss, [params["c0"], params["radius"]])
        grads.append([x.double().numpy() for x in g])
    ill = np.zeros(pscene.spheres.radius.shape[0], dtype=bool)
    for g32, g64 in zip(*grads):
        off = np.abs(g32 - g64) > 2.5e-4 * np.abs(g64) + 1e-7
        ill |= off.reshape(off.shape[0], -1).any(1)
    return ill


def test_golden_train_step_matches_jax():
    assert len(BG) == 2  # golden_scene's (bottom, top) gradient sky
    scene = jax_build_scene(NAME)
    cam = jax_camera_for_scene(NAME, aspect_ratio=W / H)
    mesh = make_mesh((1, 1), jax.devices()[:1])
    jp0 = {k: np.asarray(v) for k, v in jax_extract_params(scene).items()}
    jp1, jloss = jax_train_step(scene, cam, jnp.asarray(TARGET), W, H, SPP, DEPTH,
                                jnp.asarray(BG, jnp.float32), SEED, mesh, lr=1.0,
                                use_pallas=True, interpret=True)

    pscene = build_scene(NAME, device="cpu")
    pcam = camera_for_scene(NAME, W / H, "cpu")
    p0 = params_to_numpy(extract_params(pscene))
    sky_before = mk.launch_counts()["sky_launches"]
    p1, loss = sharded_train_step(pscene, pcam, torch.from_numpy(TARGET), W, H, SPP, DEPTH,
                                  BG, SEED, lr=1.0)
    p1 = params_to_numpy(p1)
    # on the CPU the wrapper runs the plain version: no kernel launch
    assert mk.launch_counts()["sky_launches"] == sky_before

    j_rad, j_win, p_rad, p_win, rays = _paths(scene, cam)
    diverged = (j_win != p_win).any(0)
    assert diverged.mean() <= 0.01, diverged.mean()
    bad_pix = diverged.reshape(W * H, SPP).any(1)
    bad_rays = np.repeat(bad_pix, SPP)
    touched = np.concatenate([j_win[:, bad_rays].ravel(), p_win[:, bad_rays].ravel()])
    spheres = np.unique(touched[(touched >= 0) & (touched < pscene.spheres.radius.shape[0])])
    mats = np.unique(pscene.spheres.mat_id.numpy()[spheres])
    texs = np.unique(pscene.materials.tex_id.numpy()[mats])

    # pass 1: each side's loss is the MSE of its own mean image, and the
    # images agree off the diverged pixels
    j_img, p_img = _image(j_rad), _image(p_rad)
    np.testing.assert_allclose(float(jloss), ((j_img - TARGET) ** 2).mean(), rtol=1e-5)
    np.testing.assert_allclose(float(loss), ((p_img - TARGET) ** 2).mean(), rtol=1e-5)
    good_img = ~bad_pix.reshape(H, W)[::-1]
    np.testing.assert_allclose(p_img[good_img], j_img[good_img], rtol=0, atol=1e-3)

    # spheres whose geometry gradient f32 cannot pin down to the bar
    ill = _ill_conditioned(pscene, rays, p_win, p_img)
    assert ill.sum() <= 0.05 * pscene.spheres.active.sum().item(), np.nonzero(ill)[0]
    geometry = np.union1d(spheres, np.nonzero(ill)[0])
    touched_by = {"c0": geometry, "radius": geometry, "color": texs, "fuzz": mats,
                  "ior": mats}
    for k in jp0:
        np.testing.assert_array_equal(p0[k], jp0[k])
        want = jp0[k] - np.asarray(jp1[k])
        got = p0[k] - p1[k]
        assert np.isfinite(got).all(), k
        keep = np.ones(got.shape[0], dtype=bool)
        keep[touched_by[k]] = False
        got, want = got[keep], want[keep]
        np.testing.assert_allclose(got, want, rtol=2e-3, atol=1e-6, err_msg=k)
        if k in ("c0", "radius", "color"):
            assert np.abs(want).sum() > 0.0 and np.abs(got).sum() > 0.0, k
