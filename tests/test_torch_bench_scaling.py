"""rtweekend_tpu_torch.tools.bench_scaling on the CPU: gloo ranks as
spawned processes (k = 1, 2) at 16x16, depth 4, with rows and summary
checked; a group that outlasts its timeout is killed and fails; and the
trace report's phase split on a synthetic trace."""

import json
import math
import multiprocessing

import pytest

from rtweekend_tpu_torch.tools import bench_scaling
from rtweekend_tpu_torch.utils import trace_report

from test_torch_megakernel import one_torch_thread  # noqa: F401  (autouse)


def test_bench_scaling_cpu(tmp_path, capsys):
    out = tmp_path / "scaling.json"
    assert bench_scaling.main(["--backend", "cpu", "--max-ranks", "2", "--width", "16",
                               "--height", "16", "--max-depth", "4", "--repeats", "1",
                               "--timeout", "240", "--out", str(out)]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    saved = json.loads(out.read_text())
    rows, summary = saved["rows"], saved["summary"]
    assert lines == rows + [summary]
    assert [r["devices"] for r in rows] == [1, 2]
    assert [r["spp"] for r in rows] == [4, 8]
    for r in rows:
        assert r["rays_per_s"] > 0 and r["step_s"] > 0
        assert math.isfinite(r["efficiency_vs_1dev"]) and r["efficiency_vs_1dev"] > 0
        assert set(r["phases_per_device"]) == {"compute_s", "collective_s", "wait_s"}
        assert 0.0 <= r["collective_frac_of_busy"] <= 1.0
        assert r["backend"] == "gloo" and r["rank_devices"] == ["cpu"] * r["devices"]
    assert rows[0]["efficiency_vs_1dev"] == 1.0
    assert rows[1]["phases_per_device"]["collective_s"] > 0
    assert summary["metric"] == "weak_scaling_efficiency_2ranks_cpu"
    assert summary["value"] == pytest.approx(rows[1]["efficiency_vs_1dev"])


def test_hung_group_is_killed():
    cfg = dict(scene="final_scene", width=16, height=16, spp_per_device=1, max_depth=2,
               repeats=1, train=False, backend="cpu", ranks_per_card=1, dist_backend="gloo")
    # a group given no time cannot finish: its ranks are killed and reaped
    with pytest.raises(RuntimeError, match="killed"):
        bench_scaling.run_group(2, cfg, timeout=0.0)
    assert multiprocessing.active_children() == []


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": tid, "ts": ts, "dur": dur,
            "args": args}


def test_phases_split():
    """Each instant once, collective > wait > compute."""
    events = [
        _x("cpu_op", "aten::mul", 0, 100),                  # host compute 0-100
        _x("cpu_op", "aten::add", 50, 100),                 # overlaps: 0-150 in all
        _x("cpu_op", "c10d::allreduce_", 140, 20),          # collective 140-160
        _x("user_annotation", "gloo:all_reduce", 150, 30, tid=2),   # 150-180
        _x("cuda_runtime", "cudaStreamSynchronize", 170, 30),       # wait 180-200
    ]
    assert trace_report.phases(events) == pytest.approx(
        {"compute_s": 140e-6, "collective_s": 40e-6, "wait_s": 20e-6})
    # with device events, compute is the device's; an NCCL kernel is a collective
    events += [_x("kernel", "bounce_kernel<1>", 300, 50),
               _x("kernel", "ncclDevKernel_AllReduce_Sum_f32", 360, 10)]
    assert trace_report.phases(events) == pytest.approx(
        {"compute_s": 50e-6, "collective_s": 50e-6, "wait_s": 20e-6})
