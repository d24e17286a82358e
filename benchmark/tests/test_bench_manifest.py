"""BENCHMARK.json against the benchmark's contract, and every file a cell
names found by name."""

import json
import re
from pathlib import Path

import pytest

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in MAN["workloads"]]


def test_top_level_keys_and_limits():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert MAN["paths"] == ["benchmark"]
    assert 1 <= MAN["run_seconds"] <= 51 and isinstance(MAN["run_seconds"], int)
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    # a full check with 24 cells fits: 2 + 14 n runs of run_seconds + 60 s,
    # 2 x 90 s of compile a cell, 1200 s spare, within 43200 s
    n = 24
    assert (2 + 14 * n) * (MAN["run_seconds"] + 60) + n * 180 + 1200 <= 43200
    for word in MAN["command"]:
        assert 1 <= len(word) <= 200 and not word.startswith("/") and ".." not in word


def test_names_units_and_keys():
    names = []
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        names.append(c["name"])
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
    for kind in ("end_to_end", "per_layer"):
        for m in MAN[kind]:
            names.append(m["name"])
            assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    names += CELLS
    assert all(NAME.match(n) for n in names)
    for group in (MAN["configs"], MAN["workloads"], MAN["end_to_end"] + MAN["per_layer"]):
        assert len({x["name"] for x in group}) == len(group)


def test_bounds():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e["setup_s"]
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    man, entry, cfg, wl, job = harness.cell_parts(cell)
    assert cfg["name"] == entry["config"] and wl["traffic"] == entry["traffic"]
    assert hasattr(job, "Job")
    e2e = harness.metrics_of(man, cell, "end_to_end")
    per = harness.metrics_of(man, cell, "per_layer")
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2 and per
    for m in per:
        assert m["moves"] in {x["name"] for x in e2e}
        assert callable(harness.reader(m["name"]))


def test_per_layer_cells_exist_and_layers_named_alike():
    for m in MAN["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert set(m["workloads"]) <= set(CELLS)
        assert 1 <= len(m["layer"]) <= 200


def test_configs_match_the_program_defaults():
    from rtweekend_tpu_torch.config import FOCUS_DIST, SCENE_DEFAULTS

    for c in MAN["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        d = SCENE_DEFAULTS[cfg["scene"]]
        assert (cfg["width"], cfg["height"]) == (d["width"], d["height"])
        assert cfg["sky"] == json.loads(json.dumps(d["background"]))
        assert tuple(cfg["look_from"]) == d["look_from"] and tuple(cfg["look_at"]) == d["look_at"]
        assert (cfg["vfov"], cfg["aperture"]) == (d["vfov"], d["aperture"])
        assert cfg["focus_dist"] == d.get("focus_dist", FOCUS_DIST)
        assert cfg["reduced"] == c["reduced"] == []
