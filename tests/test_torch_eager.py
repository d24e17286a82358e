"""rtweekend_tpu_torch's eager integrator against the JAX package's jnp
integrator: intersect, texture_value, scatter, trace_paths, the port's
differentiable replay (ops/replay.trace_paths_replay_fast, which shares
the integrator's scatter) against JAX's integrator.trace_paths_replay,
and the eager render against the plain bounce version's render.

The per-op comparisons run the JAX functions op by op, outside jit: a
jitted XLA program contracts a multiply and an add into one FMA, which
rounds once where PyTorch's separate ops round twice, and that last bit
is amplified on the grazing and r=1000 ground-sphere roots. Op by op,
both sides round every operation once, in the same order.

One difference remains: PyTorch's vectorized CPU sqrt is not correctly
rounded (0.56% of random float32 inputs differ from numpy's sqrt by an
ulp), and the nearest root -(hb + sqrt(disc)) / a cancels where
hb ~ -sqrt(disc) (the r=1000 ground sphere, grazing rays), which
multiplies that ulp by up to ~1e3. So the elementwise bar (rtol 1e-5,
atol 1e-6) is held on every hit whose winning sphere's discriminant gets
the correctly rounded sqrt; the others are counted (at most 2% of the
hits) and held at the lane bar below. The card's sqrt is correctly
rounded.

trace_paths and the replays run the JAX side jitted, as its render
does (4,096 rays, depth 8): there the FMA can flip a discrete decision
(closest root, Schlick draw) on a rare ray, whose path then diverges
(0.46% of golden_scene's lanes, 0.38% of final_scene's; none of the
enclosed and textured scenes'). Bars are tests/test_pallas.py's: at most
0.5% of radiance lanes off by more than 1e-3, channel means within 2%
(plus atol 5e-3 for the texture scenes).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtweekend_tpu.config import SCENE_DEFAULTS
from rtweekend_tpu.models.builders import build_scene as jax_build_scene
from rtweekend_tpu.models import scene as jax_scene_mod
from rtweekend_tpu.ops import intersect as jax_intersect
from rtweekend_tpu.ops.camera import generate_rays as jax_generate_rays
from rtweekend_tpu.ops.integrator import trace_paths as jax_trace_paths
from rtweekend_tpu.ops.integrator import trace_paths_replay as jax_trace_paths_replay
from rtweekend_tpu.ops.scatter import scatter as jax_scatter
from rtweekend_tpu.ops.textures import texture_value as jax_texture_value
from rtweekend_tpu.render import camera_for_scene as jax_camera_for_scene
from rtweekend_tpu_torch.models import scene as scene_mod
from rtweekend_tpu_torch.models.builders import build_scene
from rtweekend_tpu_torch.ops import coeffs, integrator
from rtweekend_tpu_torch.ops.replay import trace_paths_replay_fast
from rtweekend_tpu_torch.ops.cuda import megakernel as mk
from rtweekend_tpu_torch.ops.intersect import Hit, closest, resolve_hit
from rtweekend_tpu_torch.ops.scatter import scatter
from rtweekend_tpu_torch.ops.textures import texture_value
from rtweekend_tpu_torch.render import camera_for_scene, render
from rtweekend_tpu_torch.utils import vecmath

from test_torch_megakernel import one_torch_thread  # noqa: F401  (autouse)

SEED = 42
LANE_TOL, LANE_FRAC, MEAN_RTOL, TEX_MEAN_ATOL = 1e-3, 0.005, 0.02, 5e-3
# scene: (origin box low, high) for random rays inside the scene
BOXES = {"final_scene": ((-11.0, 0.05, -11.0), (11.0, 2.5, 11.0)),
         "cornell_box": ((1.0, 1.0, 1.0), (554.0, 554.0, 554.0))}
# the six scenes of the kernel-vs-plain comparisons, with their means atol
SIX = (("final_scene", 0.0), ("cornell_box", 0.0), ("two_perlin_spheres", TEX_MEAN_ATOL),
       ("simple_light", TEX_MEAN_ATOL), ("earth", TEX_MEAN_ATOL), ("golden_scene", 0.0))


def _random_rays(name, n=1024, seed=0):
    """n rays with origins uniform in the scene's box and gaussian
    directions, times in [0, 1): numpy float32."""
    g = np.random.default_rng(seed)
    lo, hi = BOXES[name]
    o = g.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = g.normal(size=(n, 3)).astype(np.float32)
    return o, d, g.uniform(0.0, 1.0, n).astype(np.float32)


def _jax_closest(scene, o, d, t):
    """(idx, t, candidate t [N, P]) of the JAX march, op by op."""
    ts = jnp.concatenate([jax_intersect.sphere_candidate_ts(scene, o, d, t, 1e-3),
                          jax_intersect.rect_candidate_ts(scene, o, d, t, 1e-3)], axis=1)
    return jnp.argmin(ts, axis=1), jnp.min(ts, axis=1)


def _sqrt_last_bit(scene, o, d, t, idx):
    """[N] bool: rays whose winning sphere's discriminant gets another
    float32 sqrt from PyTorch's CPU sqrt than from a correctly rounded one
    (numpy's); the same hb, c and a as the march (its matmul rounds as
    XLA's dot does)."""
    n_s = scene.spheres.radius.shape[0]
    feats = coeffs.ray_features(o, d, t)
    a_hb, a_cc = coeffs.sphere_coeffs(scene)
    si = idx.clamp(max=n_s - 1)[:, None]
    hb = (feats @ a_hb.t()).gather(1, si)[:, 0]
    cc = (feats @ a_cc.t()).gather(1, si)[:, 0]
    disc = (hb * hb - vecmath.norm_squared(d) * cc).clamp(min=0.0)
    return (idx < n_s).numpy() & (torch.sqrt(disc).numpy() != np.sqrt(disc.numpy()))


def _port_hit(h):
    """The port's Hit from a JAX Hit."""
    return Hit(**{k: torch.from_numpy(np.array(getattr(h, k))) for k in
                  ("t", "hit", "p", "normal", "front_face", "u", "v", "mat_id")})


@pytest.mark.parametrize("name", ["final_scene", "cornell_box"])
def test_intersect_matches_jax(name):
    o, d, t = _random_rays(name)
    jscene = jax_build_scene(name)
    pscene = build_scene(name, device="cpu")
    J = [jnp.asarray(x) for x in (o, d, t)]
    P = [torch.from_numpy(x) for x in (o, d, t)]
    j_idx, j_t = (np.asarray(x) for x in _jax_closest(jscene, *J))
    jh = jax_intersect.resolve_hit(jscene, *J, jnp.asarray(j_idx), jnp.asarray(j_t) < 5e29,
                                   jnp.asarray(j_t))
    idx, tb = closest(pscene, *P)
    ph = resolve_hit(pscene, *P, idx, tb < 5e29, tb)

    same = idx.numpy() == j_idx
    assert same.mean() >= 0.999, same.mean()
    hit = np.asarray(jh.hit)
    np.testing.assert_array_equal(ph.hit.numpy()[same], hit[same])
    np.testing.assert_array_equal(ph.mat_id.numpy()[same], np.asarray(jh.mat_id)[same])
    assert hit.mean() > 0.5
    well = same & ~_sqrt_last_bit(pscene, *P, idx)
    ill = same & hit & ~well
    assert ill.sum() <= 0.02 * hit.sum(), ill.sum()
    for k in ("t", "p", "normal", "u", "v"):
        got, want = getattr(ph, k).numpy(), np.asarray(getattr(jh, k))
        np.testing.assert_allclose(got[well & hit], want[well & hit], rtol=1e-5, atol=1e-6,
                                   err_msg=k)
        off = np.abs(got[ill] - want[ill]) > LANE_TOL * np.maximum(np.abs(want[ill]), 1.0)
        assert off.mean() <= LANE_FRAC if ill.any() else True, (k, off.mean())


def _all_textures(sm):
    """A scene of the given scene module with one sphere per texture kind:
    solid, checker, noise and an 8x6 RGBA image with alpha-0 texels."""
    img = np.random.default_rng(5).integers(0, 256, (6, 8, 4)).astype(np.uint8)
    img[::2, ::3, 3] = 0
    b = sm.SceneBuilder(perlin_seed=7)
    for i, tex in enumerate([sm.Solid((0.3, 0.6, 0.9)),
                             sm.Checker(odd=(0.2, 0.3, 0.1), even=(0.9, 0.8, 0.7)),
                             sm.Noise(scale=4.0), sm.ImageTex(data=img)]):
        b.add_sphere((3.0 * i, 0.0, 0.0), 1.0, b.material(sm.Diffuse(albedo=tex)))
    return b


def test_texture_value_every_kind_matches_jax():
    jscene = _all_textures(jax_scene_mod).build()
    pscene = _all_textures(scene_mod).build("cpu")
    assert pscene.has_checker and pscene.has_noise and pscene.has_image
    g = np.random.default_rng(11)
    n = 2048
    tex_id = g.integers(0, pscene.textures.ttype.shape[0], n).astype(np.int32)
    uv = g.uniform(-0.1, 1.1, (2, n)).astype(np.float32)   # past the clamps too
    p = g.uniform(-3.0, 3.0, (n, 3)).astype(np.float32)
    want = np.asarray(jax_texture_value(jscene, jnp.asarray(tex_id), jnp.asarray(uv[0]),
                                        jnp.asarray(uv[1]), jnp.asarray(p)))
    got = texture_value(pscene, torch.from_numpy(tex_id), torch.from_numpy(uv[0]),
                        torch.from_numpy(uv[1]), torch.from_numpy(p)).numpy()
    ttype = pscene.textures.ttype.numpy()[tex_id]
    for kind in (scene_mod.TEX_SOLID, scene_mod.TEX_CHECKER, scene_mod.TEX_IMAGE):
        sel = ttype == kind
        assert sel.sum() > 100, kind
        np.testing.assert_allclose(got[sel], want[sel], rtol=1e-5, err_msg=str(kind))
    sel = ttype == scene_mod.TEX_NOISE
    assert sel.sum() > 100
    # turbulence sums 7 octaves of 8 corners in another order (test_pallas.py)
    np.testing.assert_allclose(got[sel], want[sel], rtol=1e-5, atol=5e-3)
    # the image's alpha-0 texels give the ocean colour
    assert (got[ttype == scene_mod.TEX_IMAGE] == [0.0, 0.0, 1.0]).all(1).any()


@pytest.mark.parametrize("name", ["final_scene", "cornell_box"])
def test_scatter_on_jax_hit_matches_jax(name):
    o, d, t = _random_rays(name, seed=1)
    jscene = jax_build_scene(name)
    pscene = build_scene(name, device="cpu")
    J = [jnp.asarray(x) for x in (o, d, t)]
    jh = jax_intersect.intersect(jscene, *J)
    ids = np.arange(o.shape[0], dtype=np.int32)
    bounce = 3
    want = jax_scatter(jscene, jnp.uint32(SEED), jnp.asarray(ids), jnp.asarray(ids // 7),
                       bounce, J[1], jh)
    got = scatter(pscene, SEED, torch.from_numpy(ids), torch.from_numpy(ids // 7), bounce,
                  torch.from_numpy(d), _port_hit(jh))
    hit = np.asarray(jh.hit)
    np.testing.assert_array_equal(got.alive.numpy()[hit], np.asarray(want.alive)[hit])
    for k in ("direction", "attenuation", "emitted"):
        np.testing.assert_allclose(getattr(got, k).numpy()[hit],
                                   np.asarray(getattr(want, k))[hit], rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    mtype = pscene.materials.mtype.numpy()[np.asarray(jh.mat_id)[hit]]
    kinds = {scene_mod.MAT_DIFFUSE, scene_mod.MAT_METAL, scene_mod.MAT_DIELECTRIC}
    if name == "cornell_box":
        kinds = {scene_mod.MAT_DIFFUSE, scene_mod.MAT_LIGHT}
    assert kinds <= set(mtype.tolist())


def _camera_rays(name, n=1024):
    """The JAX camera's rays over a 32x32 pixel grid, samples 0, 1, ...:
    numpy arrays (o, d, t, pixel ids, sample ids)."""
    p = SCENE_DEFAULTS[name]
    cam = jax_camera_for_scene(name, aspect_ratio=p["width"] / p["height"])
    ids = np.arange(n, dtype=np.int32)
    pid, sid = ids % 1024, ids // 1024
    o, d, t = jax_generate_rays(cam, 32, 32, jnp.asarray(pid), jnp.asarray(sid),
                                jnp.uint32(SEED))
    return [np.array(x) for x in (o, d, t)] + [pid, sid]


def _lane_bars(got, want, mean_atol, what):
    frac = (np.abs(got - want) > LANE_TOL).mean()
    assert np.isfinite(got).all(), what
    assert frac <= LANE_FRAC, (what, frac)
    gm, wm = got.astype(np.float64).mean(0), want.astype(np.float64).mean(0)
    assert (np.abs(gm - wm) <= mean_atol + MEAN_RTOL * np.abs(wm)).all(), (what, gm, wm)


_jit_trace = jax.jit(jax_trace_paths, static_argnames=("max_depth",))
_jit_replay = jax.jit(jax_trace_paths_replay, static_argnames=("remat",))


@pytest.mark.parametrize("name,mean_atol", SIX)
def test_trace_paths_and_replay_match_jax(name, mean_atol):
    depth = 8
    rays = _camera_rays(name, 4096)
    bg = SCENE_DEFAULTS[name]["background"]
    jscene = jax_build_scene(name)
    pscene = build_scene(name, device="cpu")
    J = [jnp.asarray(x) for x in rays]
    P = [torch.from_numpy(x) for x in rays]
    jbg = jnp.asarray(bg, jnp.float32)

    want = np.asarray(_jit_trace(jscene, *J, jnp.uint32(SEED), jbg, max_depth=depth))
    got = integrator.trace_paths(pscene, *P, SEED, bg, depth).numpy()
    _lane_bars(got, want, mean_atol, f"{name} trace_paths")
    assert want.max() > 0.0

    # the same paths replayed on both sides: the plain bounce version's winners
    _, win = mk.trace_paths(mk.pack_scene(pscene), *P, SEED, bg, depth, kernel="torch",
                            return_winners=True)
    want = np.asarray(_jit_replay(jscene, *J, jnp.uint32(SEED), jbg,
                                  jnp.asarray(win.numpy()), remat=False))
    got = trace_paths_replay_fast(pscene, *P, SEED, bg, win, remat=False).numpy()
    _lane_bars(got, want, mean_atol, f"{name} trace_paths_replay_fast")


@pytest.mark.parametrize("name", ["final_scene", "cornell_box", "two_perlin_spheres"])
def test_eager_render_matches_plain_kernel_render(name):
    """render(kernel="eager") against render(kernel="torch") at 1 spp, so
    that every framebuffer entry is one ray's radiance."""
    w, h, depth = 32, 24, 8
    scene = build_scene(name, device="cpu")
    cam = camera_for_scene(name, w / h, "cpu")
    bg = SCENE_DEFAULTS[name]["background"]
    eager = render(scene, cam, w, h, 1, depth, bg, SEED, kernel="eager")
    plain = render(scene, cam, w, h, 1, depth, bg, SEED, kernel="torch")
    assert eager.dtype == torch.float32 and eager.shape == (h, w, 3)
    _lane_bars(eager.reshape(-1, 3).numpy(), plain.reshape(-1, 3).numpy(),
               TEX_MEAN_ATOL if name == "two_perlin_spheres" else 0.0, name)


def test_path_decisions_match_the_plain_kernel_winners():
    """The eager loop's per-bounce winners against the plain bounce
    version's winners on the same rays: the same paths, up to rare
    diverged rays."""
    rays = [torch.from_numpy(x) for x in _camera_rays("final_scene")]
    scene = build_scene("final_scene", device="cpu")
    alive, win = integrator.path_decisions(scene, *rays, SEED, 8)
    _, kwin = mk.trace_paths(mk.pack_scene(scene), *rays, SEED,
                             SCENE_DEFAULTS["final_scene"]["background"], 8, kernel="torch",
                             return_winners=True)
    assert alive.shape == win.shape == (8, 1024) and win.dtype == torch.int32
    assert alive[0].all() and (win[~alive] == -1).all()
    assert (win != kwin).any(0).float().mean() <= LANE_FRAC
