"""rtweekend_tpu_torch bounce megakernel: the plain version against the
Pallas kernel of rtweekend_tpu (interpret mode, as tests/test_pallas.py
runs it on the CPU) and the compacted driver. The noise, image and
gradient-sky variants are held the same way in tests/test_torch_noise.py
and tests/test_torch_image_sky.py, through _plain_vs_pallas below.

Bars are tests/test_pallas.py's for each scene. cornell_box is all rects
with few-term dot products and no glass: elementwise rtol 1e-5. On
final_scene the 17-term coefficient dots are summed in another order
than XLA's, which can flip a discrete decision (closest root, Schlick
draw) on a rare ray whose path then legitimately diverges: at most 0.5%
of lanes off by more than 1e-3, channel means within 2%.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtweekend_tpu.config import SCENE_DEFAULTS
from rtweekend_tpu.models.builders import build_scene as jax_build_scene
from rtweekend_tpu.ops.camera import generate_rays as jax_generate_rays
from rtweekend_tpu.ops.pallas.megakernel import trace_paths_pallas
from rtweekend_tpu.render import camera_for_scene as jax_camera_for_scene
from rtweekend_tpu_torch.models.builders import build_scene
from rtweekend_tpu_torch.ops.camera import generate_rays
from rtweekend_tpu_torch.ops.cuda import megakernel as mk
from rtweekend_tpu_torch.render import camera_for_scene

SEED = 42


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One PyTorch intra-op thread while a test module runs. The suite
    runs one xdist worker per core and the port's tensors are tiny: with
    PyTorch's default of one OpenMP thread per core in every worker, idle
    threads spin against each other and a test that takes 1 s alone takes
    30 s in the suite. Other port test modules import it:

        from test_torch_megakernel import one_torch_thread  # noqa: F401
    """
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rays(name, aspect, n, device="cpu"):
    """numpy-seeded counters -> the port's camera rays (32x32 pixel grid)."""
    ids = np.arange(n, dtype=np.int32)
    pid = torch.from_numpy(ids % 1024).to(device)
    sid = torch.from_numpy(ids // 1024).to(device)
    cam = camera_for_scene(name, aspect, device)
    return (*generate_rays(cam, 32, 32, pid, sid, SEED), pid, sid)


def _plain_vs_pallas(name, depth, aspect, scenes=None, bg=None):
    """(port plain radiance, JAX interpret-mode radiance) [1024, 3] on the
    JAX camera rays of scene `name`; `scenes` (JAX scene, port scene) and
    `bg` replace the registry scene and its background."""
    n = 1024
    ids = np.arange(n, dtype=np.int32)
    pid, sid = jnp.asarray(ids % 1024), jnp.asarray(ids // 1024)
    cam = jax_camera_for_scene(name, aspect_ratio=aspect)
    o, d, t = jax_generate_rays(cam, 32, 32, pid, sid, jnp.uint32(SEED))
    if bg is None:
        bg = SCENE_DEFAULTS[name]["background"]
    if scenes is None:
        scenes = jax_build_scene(name), build_scene(name, device="cpu")
    want = np.asarray(trace_paths_pallas(
        scenes[0], o, d, t, pid, sid, jnp.uint32(SEED),
        jnp.asarray(bg, jnp.float32), depth, interpret=True,
    ))
    # same rays on both sides: the JAX camera's output, carried as numpy
    tt = [torch.from_numpy(np.array(x)) for x in (o, d, t, pid, sid)]
    tables = mk.pack_scene(scenes[1])
    got = mk.trace_paths(tables, *tt, SEED, bg, depth).numpy()
    return got, want


def test_plain_vs_pallas_cornell_box():
    got, want = _plain_vs_pallas("cornell_box", 6, 1.0)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_plain_vs_pallas_final_scene():
    got, want = _plain_vs_pallas("final_scene", 8, 16 / 9)
    assert want.mean() > 0.1  # sky-lit scene is bright
    diverged = (np.abs(got - want) > 1e-3).mean()
    assert diverged < 0.005, f"too many diverged lanes: {diverged}"
    np.testing.assert_allclose(got.mean(axis=0), want.mean(axis=0), rtol=0.02)


def test_compacted_bit_equal_to_uncompacted():
    """RNG is keyed by (pixel, sample, bounce), never by buffer position,
    and a ray adds radiance at most once: compaction changes no bit."""
    tables = mk.pack_scene(build_scene("final_scene", device="cpu"))
    rays = _rays("final_scene", 16 / 9, 2500)  # not a TILE multiple
    bg = SCENE_DEFAULTS["final_scene"]["background"]
    full = mk.trace_paths(tables, *rays, SEED, bg, 9)
    state = mk.init_state(*rays)
    comp, overflow = mk.trace_paths_compact(
        tables, state, 2500, SEED, bg, 9, capacities=((1, 0.9), (3, 0.5), (6, 0.3)))
    assert not overflow.item()
    assert torch.equal(comp, full)
    # an unsorted, duplicated schedule behaves as its sorted dedupe
    again, _ = mk.trace_paths_compact(
        tables, state, 2500, SEED, bg, 9,
        capacities=((6, 0.3), (3, 0.5), (1, 0.9), (3, 0.5)))
    assert torch.equal(again, full)


def test_compaction_overflow_raises_flag():
    tables = mk.pack_scene(build_scene("cornell_box", device="cpu"))
    rays = _rays("cornell_box", 1.0, 4096)  # enclosed: rays stay alive
    bg = (0.0, 0.0, 0.0)
    state = mk.init_state(*rays)
    r, overflow = mk.trace_paths_compact(tables, state, 4096, SEED, bg, 6,
                                         capacities=((2, 0.1),))
    assert overflow.item()
    assert torch.isfinite(r).all()
    r2, overflow2 = mk.trace_paths_compact(tables, state, 4096, SEED, bg, 6,
                                           capacities=((2, 0.9),))
    assert not overflow2.item()
    assert torch.equal(r2, mk.trace_paths(tables, *rays, SEED, bg, 6))


def test_compact_keeps_live_rows_in_order():
    state = mk.init_state(*(x[:10] for x in _rays("final_scene", 16 / 9, 10)))
    state[[1, 4, 5], mk.S_AL] = 0.0
    g, overflow = mk.compact(state, torch.tensor(7), 4)
    assert overflow.item()
    np.testing.assert_array_equal(g[:, mk.S_RID].view(torch.int32).numpy(), [0, 2, 3, 6])
    g, overflow = mk.compact(state[:10].clone(), torch.tensor(7), 1024)
    assert not overflow.item()
    rid = g[:, mk.S_RID].view(torch.int32).numpy()
    np.testing.assert_array_equal(rid[:7], [0, 2, 3, 6, 7, 8, 9])
    assert (rid[7:] == 9).all() and (g[7:, mk.S_AL] == 0).all()
