"""The bounce segment's one write-out (`accum`): each row alive at entry
adds its radiance into the caller's [3, cols] total at its ray id, and rows
dead at entry, among them a compacted buffer's padding rows that all repeat
one ray id, add nothing. Held here on the plain version (the kernel's twin
on the CPU; tests/test_torch_cuda.py holds the kernel): a compacted buffer
against the same launch on its live rows alone, the winners variant
against the radiance-only launch and trace_paths' winners, and
trace_paths_compact against the uncompacted trace, with and without an
overflow. Every comparison is bit for bit.
"""

import pytest
import torch

from rtweekend_tpu_torch.config import SCENE_DEFAULTS
from rtweekend_tpu_torch.models.builders import build_scene
from rtweekend_tpu_torch.ops.cuda import megakernel as mk
from rtweekend_tpu_torch.ops.camera import generate_rays
from rtweekend_tpu_torch.render import camera_for_scene

from test_torch_megakernel import one_torch_thread  # noqa: F401

SEED = 42
W = H = 32
DEPTH = 8
# (scene, aspect, capacities that leave most of each compacted buffer as
# padding, capacities that overflow)
SCENES = {
    "final_scene": (16 / 9, ((1, 0.9), (3, 0.6), (5, 0.4)), ((1, 0.05),)),
    "cornell_box": (1.0, ((2, 0.95), (4, 0.9), (6, 0.85)), ((2, 0.1),)),
}


def _setup(name, spp=2):
    aspect = SCENES[name][0]
    n = W * H * spp
    ids = torch.arange(n, dtype=torch.int32)
    pid, sid = ids % (W * H), torch.div(ids, W * H, rounding_mode="floor")
    cam = camera_for_scene(name, aspect, "cpu")
    rays = (*generate_rays(cam, W, H, pid, sid, SEED), pid, sid)
    tables = mk.pack_scene(build_scene(name, device="cpu"))
    return tables, rays, n, SCENE_DEFAULTS[name]["background"]


def _segment(tables, state, b0, n_b, bg, cols=None, **kw):
    """The plain launch over state onto a zero total [3, cols] (default:
    the state's rows): (total, state[, winners])."""
    total = torch.zeros((3, state.shape[0] if cols is None else cols))
    out = mk.trace_segment_plain(tables, state, SEED, bg, b0, n_b, accum=total, **kw)
    return (total, *out) if kw.get("want_winners") else (total, out)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_accum_equals_index_add_of_rad(name):
    """A compacted buffer whose padding rows share one ray id, onto a
    nonzero total: the same total and live rows as the launch over its
    live rows alone, and the padding rows pass through untouched."""
    tables, rays, n, bg = _setup(name)
    state = mk.init_state(*rays)
    _, state = _segment(tables, state, 0, 2, bg)
    count = (state[:, mk.S_AL] > 0.5).sum()
    cap = mk._tiles(int(2.5 * count))
    comp, overflow = mk.compact(state, count, cap)
    assert not overflow.item()
    pad = comp[count:, mk.S_RID].view(torch.int32)
    assert pad.numel() > comp.shape[0] // 2 and (pad == pad[0]).all()

    base = torch.rand((3, state.shape[0]), generator=torch.Generator().manual_seed(1))
    want = base.clone()
    live = comp[:count].clone()
    want_live = mk.trace_segment_plain(tables, live, SEED, bg, 2, 3, accum=want)
    got = base.clone()
    got_state = mk.trace_segment_plain(tables, comp, SEED, bg, 2, 3, accum=got)
    assert torch.equal(got_state[:count], want_live)
    assert torch.equal(got_state[count:], comp[count:])
    assert torch.equal(got, want)
    assert not torch.equal(got, base)   # some ray finished with radiance
    # the wrapper takes the plain version for CPU tensors
    again = base.clone()
    mk.trace_segment(tables, comp, SEED, bg, 2, 3, accum=again)
    assert torch.equal(again, want)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_accum_with_winners(name):
    """want_winners changes neither the total nor the state of the
    radiance-only launch, and its winners are trace_paths'."""
    tables, rays, n, bg = _setup(name, spp=1)
    state = mk.init_state(*rays)
    total, st = _segment(tables, state, 0, 4, bg)
    total_w, st_w, win = _segment(tables, state, 0, 4, bg, want_winners=True)
    assert torch.equal(total_w, total) and torch.equal(st_w, st)
    rad, want = mk.trace_paths(tables, *rays, SEED, bg, 4, return_winners=True)
    assert torch.equal(win[:, :n], want)
    assert torch.equal(total[:, :n].t(), rad)


@pytest.mark.parametrize("kernel", ["auto", "torch"])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_compact_trace_equals_scatter_and_uncompacted(name, kernel):
    """trace_paths_compact, under capacities that leave most of each
    compacted buffer as padding, is bit-equal to the uncompacted
    trace_paths."""
    tables, rays, n, bg = _setup(name)
    caps = SCENES[name][1]
    state = mk.init_state(*rays)
    got, overflow = mk.trace_paths_compact(tables, state, n, SEED, bg, DEPTH,
                                           capacities=caps, kernel=kernel)
    assert not overflow.item()
    assert len(mk.schedule(n, DEPTH, caps)) > 1
    assert torch.equal(got, mk.trace_paths(tables, *rays, SEED, bg, DEPTH, kernel=kernel))


@pytest.mark.parametrize("name", sorted(SCENES))
def test_compact_trace_overflow_equals_scatter(name):
    """A capacity that overflows drops live rays: the flag is raised, the
    rays alive at the boundary past the capacity (in row order) add
    nothing, and every other ray adds what trace_paths gives it."""
    tables, rays, n, bg = _setup(name)
    caps = SCENES[name][2]
    state = mk.init_state(*rays)
    got, overflow = mk.trace_paths_compact(tables, state, n, SEED, bg, DEPTH, capacities=caps)
    assert overflow.item()
    (_, b, _), (_, _, cap) = mk.schedule(n, DEPTH, caps)
    _, at_b = _segment(tables, state, 0, b, bg)
    dropped = torch.nonzero(at_b[:, mk.S_AL] > 0.5).flatten()[cap:]
    full = mk.trace_paths(tables, *rays, SEED, bg, DEPTH)
    want = full.clone()
    want[dropped] = 0.0
    assert not torch.equal(want, full)   # a dropped ray would have added radiance
    assert torch.equal(got, want)
