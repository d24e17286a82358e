"""The bounce kernel's launch shape and tie rule, on the CPU.

The CUDA kernel (csrc/megakernel.cu) runs persistent blocks with G lanes
a ray; the wrapper picks G and the grid in plain Python
(megakernel.launch_shape), held here. The kernel's lane groups reduce
(t, index) with the lower index winning an exact tie: the tie scene of
tests/test_torch_cuda.py through the plain version gives the winners of
the JAX package's Pallas kernel (interpret mode), which take the lowest
index too (megakernel.py:576-581). The card holds the kernel to the same
rule at every G (test_torch_cuda.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtweekend_tpu.models import scene as jax_scene
from rtweekend_tpu.ops.camera import generate_rays as jax_generate_rays
from rtweekend_tpu.ops.pallas import megakernel as jmk
from rtweekend_tpu.render import camera_for_scene as jax_camera_for_scene
from rtweekend_tpu_torch.models import scene as port_scene
from rtweekend_tpu_torch.models.builders import build_scene
from rtweekend_tpu_torch.ops.cuda import megakernel as mk

from test_torch_cuda import TIE_LOSERS, TIE_WINNERS, tie_scene
from test_torch_megakernel import one_torch_thread  # noqa: F401  (autouse)

SEED = 42
# (SMs, resident blocks an SM): the H100 at final_scene's 80 KB table, and others
CARDS = [(132, 2), (16, 3)]
# coefficient rows the scan reads, 2 s_live + 6 r_live: final_scene (972),
# cornell_box (108), a 64-row table, the two-sphere scenes (4)
TABLES = (972, 108, 64, 4)
SHRINKING = (811008, 364544, 240640, 108544, 81920, 24576, 16384, 8192, 5120, 3072,
             1024, 100, 1)


@pytest.mark.parametrize("n_sm,per_sm", CARDS)
@pytest.mark.parametrize("n_rows", TABLES)
def test_full_batch_fills_every_resident_block(n_sm, per_sm, n_rows):
    """The 1200x675 render's 811,008-lane first segment (3 bounces) fills
    every card above with one lane a ray and every resident block; so
    does any buffer on a small table."""
    for n_b in (1, 3):
        assert mk.launch_shape(811008, n_sm, per_sm, n_rows, n_b) == (1, n_sm * per_sm)
    if n_rows < 256:
        assert mk.launch_shape(811008, n_sm, per_sm, n_rows, 50) == (1, n_sm * per_sm)


@pytest.mark.parametrize("n_sm,per_sm", CARDS)
@pytest.mark.parametrize("n_rows", TABLES)
@pytest.mark.parametrize("n_bounces", (3, 50))
def test_group_grows_as_the_buffer_shrinks(n_sm, per_sm, n_rows, n_bounces):
    """G never falls as m shrinks (at a fixed segment length) and stays
    within 32 and within 8 rows a lane; it is the smallest allowed G that
    fills the resident threads F times over (F = n_bounces + 3 on a table
    of 256 rows or more while m alone fills them, else 1.5), or the
    largest allowed once none does; the grid never exceeds the resident
    blocks nor the blocks m * G lanes need."""
    full = n_sm * per_sm
    threads = full * mk.BLOCK
    top = max(g for g in mk.GROUPS if g == 1 or g * 8 <= n_rows)
    last = 1
    for m in SHRINKING:
        g, blocks = mk.launch_shape(m, n_sm, per_sm, n_rows, n_bounces)
        assert g in mk.GROUPS and g <= min(32, top)
        fill = n_bounces + 3 if n_rows >= 256 and m >= threads else 1.5
        fills = [h for h in mk.GROUPS if h <= top and m * h >= fill * threads]
        assert g == (fills[0] if fills else top)
        assert 1 <= blocks <= full and blocks == min(full, -(-m * g // mk.BLOCK))
        if fill == 1.5:   # below the heavy regime G only grows as m shrinks
            assert g >= last
            last = g
    assert last == top


def test_segments_on_the_h100():
    """On the H100 at two blocks an SM (final_scene's and golden_scene's
    80 KB tables) the rule takes the G that timed fastest at each segment,
    or one within 3% of it (tools/segments.py --groups, PERF.md):
    final_scene's five render segments 1, 2, 8, 8, 16; golden_scene's 2,
    4, 8, 32, 32; the train step's 811,008 lanes at depth 50 take 8."""
    final = [(811008, 3), (364544, 3), (81920, 6), (16384, 8), (8192, 30)]
    golden = [(240640, 3), (108544, 3), (24576, 6), (5120, 8), (3072, 30)]
    assert [mk.launch_shape(m, 132, 2, 972, n)[0] for m, n in final] == [1, 2, 8, 8, 16]
    assert [mk.launch_shape(m, 132, 2, 974, n)[0] for m, n in golden] == [2, 4, 8, 32, 32]
    assert mk.launch_shape(811008, 132, 2, 972, 50) == (8, 264)
    # the one- and two-sphere scenes scan 2 to 10 rows: 1 lane a ray
    for m, n in golden:
        assert mk.launch_shape(m, 132, 2, 4, n) == (1, min(264, -(-m // 256)))


def test_forced_group():
    assert mk.launch_shape(811008, 132, 2, 1024, 3, group=4) == (4, 264)
    assert mk.launch_shape(1024, 132, 2, 1024, 8, group=2) == (2, 8)
    assert mk.launch_shape(1024, 132, 2, 64, 8, group=32) == (32, 128)
    for bad in (0, 3, 64):
        with pytest.raises(ValueError, match="group must be one of"):
            mk.launch_shape(1024, 132, 2, 1024, 8, group=bad)


@pytest.mark.parametrize("name,s_live,r_live", [
    ("final_scene", 486, 0), ("cornell_box", 0, 18), ("simple_light", 2, 1)])
def test_scan_stops_at_the_last_active_primitive(name, s_live, r_live):
    """The kernel scans spheres and rects up to the last active one of
    each: the padding after them has zero coefficient rows (t = BIG). A
    gap of inactive primitives before the last active one is still
    scanned."""
    import dataclasses

    scene = build_scene(name, device="cpu")
    tables = mk.pack_scene(scene)
    assert (tables.s_live, tables.r_live) == (s_live, r_live)
    assert tables.s_pad % 8 == 0 and tables.s_live <= tables.s_pad
    rows, pad = tables.coef[:, :17], tables.s_pad
    assert not rows[s_live:pad].any() and not rows[pad + s_live:2 * pad].any()
    if s_live > 2:
        active = scene.spheres.active.clone()
        active[1] = False
        gap = dataclasses.replace(scene, spheres=dataclasses.replace(scene.spheres, active=active))
        assert mk.pack_scene(gap).s_live == s_live


def test_kernel_arguments_need_an_aligned_table():
    """The kernel bulk-copies 80-byte coefficient rows: a table that does
    not start on 16 bytes is refused before any launch."""
    tables = mk.pack_scene(build_scene("cornell_box", device="cpu"))
    state = mk.init_state(torch.zeros(4, 3), torch.ones(4, 3), torch.zeros(4),
                          torch.arange(4, dtype=torch.int32), torch.zeros(4, dtype=torch.int32))
    mk._check_cuda_args(tables, state)
    flat = torch.zeros(tables.coef.numel() + 1)
    flat[1:] = tables.coef.reshape(-1)
    tables.coef = flat[1:].view(tables.coef.shape)
    assert tables.coef.is_contiguous() and tables.coef.data_ptr() % 16 == 4
    with pytest.raises(ValueError, match="16-byte aligned"):
        mk._check_cuda_args(tables, state)


def test_ties_take_the_lowest_index_like_the_pallas_kernel():
    """An exact tie goes to the lowest index in the plain version as in the
    Pallas kernel: the duplicated sphere and rect never win, the first
    copies do, and the winners agree on the entries alive on both sides
    (liveness by stepping each one bounce at a time)."""
    n, depth = 1024, 4
    ids = np.arange(n, dtype=np.int32)
    pid, sid = jnp.asarray(ids % 1024), jnp.asarray(ids // 1024)
    cam = jax_camera_for_scene("two_perlin_spheres", aspect_ratio=1.5)
    o, d, t = jax_generate_rays(cam, 32, 32, pid, sid, jnp.uint32(SEED))
    bg = (0.7, 0.8, 1.0)
    jscene = tie_scene(jax_scene).build()
    jrays = (o, d, t, pid, sid)
    jbg = jnp.asarray(bg, jnp.float32)
    _, want = jmk.trace_paths_pallas(jscene, *jrays, jnp.uint32(SEED), jbg, depth,
                                     interpret=True, return_winners=True)
    want = np.asarray(want)
    rays = [torch.from_numpy(np.array(x)) for x in jrays]
    tables = mk.pack_scene(tie_scene(port_scene).build("cpu"))
    _, got = mk.trace_paths(tables, *rays, SEED, bg, depth, return_winners=True)
    got = got.numpy()

    jtab, jstate = jmk._pack_scene(jscene), jmk._init_state(*jrays)
    state = mk.init_state(*rays)
    total = torch.zeros((3, state.shape[0]))   # not read
    live = np.ones((depth, n), dtype=bool)
    for b in range(depth):
        live[b] = (np.asarray(jstate["al"])[:n] > 0.5) & (state[:n, mk.S_AL] > 0.5).numpy()
        _, jstate = jmk._trace_segment(jtab, jstate, jnp.uint32(SEED), jbg, jnp.int32(b), 1,
                                       interpret=True, **jmk._static_meta(jscene))
        state = mk.trace_segment_plain(tables, state, SEED, bg, b, 1, accum=total)
    for lost, won in zip(TIE_LOSERS(tables.s_pad), TIE_WINNERS(tables.s_pad)):
        assert not (got == lost).any()
        assert not (want[live] == lost).any()
        assert (got[0] == won).sum() > 20   # the tied pair is in view
    np.testing.assert_array_equal(got[0], want[0])
    assert (got[live] != want[live]).mean() <= 0.005
