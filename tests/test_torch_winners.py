"""Per-bounce winners of rtweekend_tpu_torch's bounce kernel (plain
version on the CPU) against the Pallas kernel's want_winners output
(rtweekend_tpu trace_paths_pallas(return_winners=True), interpret mode).

Winners are compared only on (bounce, ray) entries where the ray is alive
entering that bounce on both sides: the Pallas kernel leaves the entries
of dead lanes unspecified (it writes where(hit, idx, -1) for every lane
of a live tile), the port writes -1 there, and the replay never reads
them. Liveness comes from stepping each kernel one bounce at a time.

Bars. Both kernels sum the coefficient dots in their own order (the
port in column order, XLA as a blocked matmul), so a candidate t may
differ in its last bits. On cornell_box the first bounce (camera rays,
all rects) is equal on every entry; from the second bounce a ray that
leaves a hit point within rounding of a box edge can see a face on one
side and miss it on the other (3 of 1024 rays at depth 6: a face at
t = 0.0046 on the port's side), and its path diverges. Those rays carry
zero radiance here, which is why test_torch_megakernel's elementwise
radiance bar holds. So both scenes get the statistical lane bar of
tests/test_pallas.py: at most 0.5% of live entries differ. Radiance with
winners is bit-equal to radiance without.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtweekend_tpu.config import SCENE_DEFAULTS
from rtweekend_tpu.models.builders import build_scene as jax_build_scene
from rtweekend_tpu.ops.camera import generate_rays as jax_generate_rays
from rtweekend_tpu.ops.pallas import megakernel as jmk
from rtweekend_tpu.render import camera_for_scene as jax_camera_for_scene
from rtweekend_tpu_torch.models.builders import build_scene
from rtweekend_tpu_torch.ops.cuda import megakernel as mk

from test_torch_megakernel import one_torch_thread  # noqa: F401  (autouse)

SEED = 42
N = 1024


def _jax_alive(scene, rays, bg, depth):
    """[depth, N] bool: alive entering each bounce, Pallas kernel stepped
    one bounce at a time."""
    tables = jmk._pack_scene(scene)
    state = jmk._init_state(*rays)
    alive = []
    for b in range(depth):
        alive.append(np.asarray(state["al"]) > 0.5)
        _, state = jmk._trace_segment(tables, state, jnp.uint32(SEED), bg, jnp.int32(b), 1,
                                      interpret=True, **jmk._static_meta(scene))
    return np.stack(alive)[:, :N]


def _port_alive(tables, rays, bg, depth):
    state = mk.init_state(*rays)
    alive = []
    for b in range(depth):
        alive.append((state[:, mk.S_AL] > 0.5).numpy())
        _, state = mk.trace_segment_plain(tables, state, SEED, bg, b, 1)
    return np.stack(alive)[:, :N]


def _winners(name, depth, aspect):
    ids = np.arange(N, dtype=np.int32)
    pid, sid = jnp.asarray(ids % 1024), jnp.asarray(ids // 1024)
    cam = jax_camera_for_scene(name, aspect_ratio=aspect)
    o, d, t = jax_generate_rays(cam, 32, 32, pid, sid, jnp.uint32(SEED))
    bg = SCENE_DEFAULTS[name]["background"]
    jscene = jax_build_scene(name)
    jrays = (o, d, t, pid, sid)
    jbg = jnp.asarray(bg, jnp.float32)
    _, want = jmk.trace_paths_pallas(jscene, *jrays, jnp.uint32(SEED), jbg, depth,
                                     interpret=True, return_winners=True)
    # same rays on both sides: the JAX camera's output, carried as numpy
    rays = [torch.from_numpy(np.array(x)) for x in jrays]
    tables = mk.pack_scene(build_scene(name, device="cpu"))
    rad, got = mk.trace_paths(tables, *rays, SEED, bg, depth, return_winners=True)
    plain_rad = mk.trace_paths(tables, *rays, SEED, bg, depth)
    assert torch.equal(rad, plain_rad)
    port_alive = _port_alive(tables, rays, bg, depth)
    live = port_alive & _jax_alive(jscene, jrays, jbg, depth)
    got = got.numpy()
    assert got.shape == (depth, N) and got.dtype == np.int32
    assert (got >= -1).all() and (got < tables.s_pad + tables.r_pad).all()
    assert (got[~port_alive] == -1).all()
    return got, np.asarray(want), live


def test_winners_cornell_box():
    got, want, live = _winners("cornell_box", 6, 1.0)
    assert live.sum() > 3 * N  # enclosed: rays stay alive
    np.testing.assert_array_equal(got[0], want[0])
    differ = (got[live] != want[live]).mean()
    assert differ <= 0.005, f"{differ:.5f} of live winner entries differ"


def test_winners_final_scene_within_lane_bar():
    got, want, live = _winners("final_scene", 8, 16 / 9)
    assert live.sum() > N
    differ = (got[live] != want[live]).mean()
    assert differ <= 0.005, f"{differ:.5f} of live winner entries differ"
    assert (want[live] >= 0).mean() > 0.5  # most live bounces hit something


@pytest.mark.parametrize("name", ["final_scene", "cornell_box"])
def test_trace_segment_winners_rows(name):
    """A segment from b0 > 0 writes n_bounces rows; dead rows are -1 and
    radiance and state equal the radiance-only call bit for bit."""
    tables = mk.pack_scene(build_scene(name, device="cpu"))
    ids = torch.arange(256, dtype=torch.int32)
    r = np.random.default_rng(3)
    centre, spread = ((0.0, 1.0, 0.0), 0.1) if name == "final_scene" \
        else ((278.0, 278.0, -800.0), 10.0)
    o = torch.from_numpy((r.normal(size=(256, 3)) * spread + centre).astype(np.float32))
    d = torch.from_numpy((r.normal(size=(256, 3)) + (0.0, 0.0, 2.0)).astype(np.float32))
    state = mk.init_state(o, d, torch.full((256,), 0.5), ids, ids * 0)
    state[::3, mk.S_AL] = 0.0
    bg = SCENE_DEFAULTS[name]["background"]
    rad, st = mk.trace_segment(tables, state, SEED, bg, 2, 3)
    rad_w, st_w, win = mk.trace_segment(tables, state, SEED, bg, 2, 3, want_winners=True)
    assert torch.equal(rad, rad_w) and torch.equal(st, st_w)
    assert win.shape == (3, state.shape[0]) and win.dtype == torch.int32
    assert (win[:, ::3] == -1).all()
    assert (win[:, 256:] == -1).all()  # padding rows are dead
