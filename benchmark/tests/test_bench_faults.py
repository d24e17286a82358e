"""The check decides `correct` as it should: whole runs of each job at a
tiny size on the CPU (the harness's look for a card skipped) are correct,
and come out not correct with the control in the program's place or with
a fault planted under the timed path. The card-only test drives a short
run of a cell on the card."""

import time

import pytest

from benchmark import faults, harness

pytestmark = pytest.mark.usefixtures("one_torch_thread")
SEED = 3_000_000_019
# The cells' limits are set from readings at the cells' own sizes on the
# card (PERF.md); these tiny runs take limits of their own.
TINY = {
    "final_scene.render": dict(cfg=dict(width=40, height=24, max_depth=5),
                               wl=dict(spp=6, warm_spp=1, check_pixels=300,
                                       limits={"off2_pct": 1.0, "mean_abs_diff": 0.2})),
    "golden_scene.train": dict(cfg=dict(width=24, height=16, max_depth=5),
                               wl=dict(spp=2, target_spp=2,
                                       limits={"loss_gap": 0.01, "grad_gap": 0.05,
                                               "change_gap": 0.05, "geom_grad_gap": 0.05})),
}


def _parts(cell):
    man, entry, cfg, wl, job = harness.cell_parts(cell)
    return man, entry, dict(cfg, **TINY[cell]["cfg"]), dict(wl, **TINY[cell]["wl"]), job


def _run(cell, **kw):
    return harness.run_cell(cell, SEED, 0.3, False, t_start=time.perf_counter(),
                            device="cpu", parts=_parts(cell), **kw)


@pytest.mark.parametrize("cell", sorted(TINY))
def test_sound_run_is_correct(cell):
    r = _run(cell)
    assert r["correct"], r["compared"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert list(r)[-1] == "compared"


@pytest.mark.parametrize("cell", sorted(TINY))
def test_control_is_not_correct(cell):
    r = _run(cell, control=True)
    assert not r["correct"], r["compared"]


@pytest.mark.parametrize("cell,fault", [(c, f) for c in sorted(TINY)
                                        for f in faults.FAULTS[_parts(c)[3]["job"]]])
def test_planted_fault_is_not_correct(cell, fault):
    with faults.planted(fault):
        r = _run(cell)
    assert not r["correct"], (fault, r["compared"])


@pytest.mark.cuda
def test_short_run_on_the_card(card):
    r = harness.run_cell("final_scene.preview", SEED, 1.0, False,
                         t_start=time.perf_counter())
    assert r["correct"], r["compared"]
    assert r["device"]["platform"] == "gpu" and r["metrics"]["frame_s_p90"]["value"] > 0
