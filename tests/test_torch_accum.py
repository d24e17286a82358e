"""The bounce segment's accumulation contract (`accum`): each row alive at
entry adds its radiance into the caller's [3, cols] buffer at its ray id,
and rows dead at entry, among them a compacted buffer's padding rows that
all repeat one ray id, add nothing. Held here on the plain version (the
kernel's twin on the CPU; tests/test_torch_cuda.py holds the kernel) against
the radiance delta scattered by a per-channel index_add_ over every row,
and trace_paths_compact built on it against that scatter and against the
uncompacted trace. Every comparison is bit for bit.
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


def _scatter_compact(tables, state, n, bg, capacities):
    """trace_paths_compact as a radiance delta a segment, scattered into the
    total by a dense add before the first compaction and a per-channel
    index_add_ over every row after it, padding rows included."""
    total = torch.zeros((3, state.shape[0]))
    count = torch.tensor(n)
    overflow = torch.tensor(False)
    for b0, n_b, out_cap in mk.schedule(n, DEPTH, capacities):
        if out_cap < state.shape[0]:
            state, ovf = mk.compact(state, count, out_cap)
            overflow = overflow | ovf
        rad, state = mk.trace_segment_plain(tables, state, SEED, bg, b0, n_b)
        if out_cap == total.shape[1]:
            total += rad
        else:
            rid = mk._int_col(state, mk.S_RID).long()
            for c in range(3):
                total[c].index_add_(0, rid, rad[c])
        count = (state[:, mk.S_AL] > 0.5).sum()
    return total[:, :n].t(), overflow


@pytest.mark.parametrize("name", sorted(SCENES))
def test_accum_equals_index_add_of_rad(name):
    """A compacted buffer whose padding rows share one ray id: the segment
    with accum adds, onto a nonzero total, exactly what index_add_ of its
    radiance delta over every row adds, and carries the same state."""
    tables, rays, n, bg = _setup(name)
    state = mk.init_state(*rays)
    _, state = mk.trace_segment_plain(tables, state, SEED, bg, 0, 2)
    count = (state[:, mk.S_AL] > 0.5).sum()
    cap = mk._tiles(int(2.5 * count))
    comp, overflow = mk.compact(state, count, cap)
    assert not overflow.item()
    pad = comp[count:, mk.S_RID].view(torch.int32)
    assert pad.numel() > comp.shape[0] // 2 and (pad == pad[0]).all()

    base = torch.rand((3, state.shape[0]), generator=torch.Generator().manual_seed(1))
    rad, want_state = mk.trace_segment_plain(tables, comp, SEED, bg, 2, 3)
    want = base.clone()
    rid = comp[:, mk.S_RID].view(torch.int32).long()
    for c in range(3):
        want[c].index_add_(0, rid, rad[c])
    got = base.clone()
    none, got_state = mk.trace_segment_plain(tables, comp, SEED, bg, 2, 3, accum=got)
    assert none is None
    assert torch.equal(got_state, want_state)
    assert torch.equal(got, want)
    assert not torch.equal(got, base)   # some ray finished with radiance
    # the wrapper takes the plain version for CPU tensors, accum included
    again = base.clone()
    mk.trace_segment(tables, comp, SEED, bg, 2, 3, accum=again)
    assert torch.equal(again, want)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_accum_with_winners(name):
    """accum and want_winners together: the winners and state of the
    radiance-delta call, and the delta added at the ray ids."""
    tables, rays, n, bg = _setup(name, spp=1)
    state = mk.init_state(*rays)
    rad, st, win = mk.trace_segment_plain(tables, state, SEED, bg, 0, 4, want_winners=True)
    total = torch.zeros((3, state.shape[0]))
    none, st2, win2 = mk.trace_segment_plain(tables, state, SEED, bg, 0, 4,
                                             want_winners=True, accum=total)
    assert none is None and torch.equal(st2, st) and torch.equal(win2, win)
    assert torch.equal(total, rad)


@pytest.mark.parametrize("kernel", ["auto", "torch"])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_compact_trace_equals_scatter_and_uncompacted(name, kernel):
    """trace_paths_compact (radiance added at the ray ids) is bit-equal to
    the scatter of radiance deltas, and to trace_paths when nothing
    overflows."""
    tables, rays, n, bg = _setup(name)
    caps = SCENES[name][1]
    state = mk.init_state(*rays)
    got, overflow = mk.trace_paths_compact(tables, state, n, SEED, bg, DEPTH,
                                           capacities=caps, kernel=kernel)
    want, want_ovf = _scatter_compact(tables, state, n, bg, caps)
    assert not overflow.item() and not want_ovf.item()
    assert torch.equal(got, want)
    assert torch.equal(got, mk.trace_paths(tables, *rays, SEED, bg, DEPTH, kernel=kernel))


@pytest.mark.parametrize("name", sorted(SCENES))
def test_compact_trace_overflow_equals_scatter(name):
    """A capacity that overflows drops live rays: the flag is raised and
    the total is still the scatter's, bit for bit."""
    tables, rays, n, bg = _setup(name)
    caps = SCENES[name][2]
    state = mk.init_state(*rays)
    got, overflow = mk.trace_paths_compact(tables, state, n, SEED, bg, DEPTH, capacities=caps)
    want, want_ovf = _scatter_compact(tables, state, n, bg, caps)
    assert overflow.item() and want_ovf.item()
    assert torch.equal(got, want)
