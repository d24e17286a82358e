"""rtweekend_tpu_torch.utils.trace_report: the device-time report of the
Chrome traces that utils/profiling.trace writes (the CLI's --profile-dir).
A real trace taken here (no card: no device events, totals 0) parses; a
small synthetic trace in torch.profiler's format, with kernel, memcpy,
memset, cpu_op and cuda_runtime events and their links, gives exact
totals in every group; the newest trace of a directory is the one read; a
directory without a trace raises FileNotFoundError."""

import json
import os

import pytest
import torch

from rtweekend_tpu_torch.utils import trace_report
from rtweekend_tpu_torch.utils.profiling import trace

from test_torch_megakernel import one_torch_thread  # noqa: F401  (autouse)


def _x(cat, name, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 1, "ts": 0.0, "dur": dur,
            "args": args}


# device events: 10 + 20 us of bounce_kernel launched by ctypes code with no
# op around it (one linked only through its runtime call's correlation),
# 30 us of index_add under aten::index_add_, 40 us of memcpy under
# aten::copy_, 5 us of memset under aten::zero_ (linked by correlation)
SYNTHETIC = [
    {"ph": "M", "name": "process_name", "pid": 0, "args": {"name": "python"}},
    _x("cpu_op", "aten::index_add_", 100, **{"External id": 7}),
    _x("cpu_op", "aten::copy_", 100, **{"External id": 8}),
    _x("cpu_op", "aten::zero_", 100, **{"External id": 9}),
    _x("cuda_runtime", "cudaLaunchKernel", 3, correlation=501, **{"External id": 0}),
    _x("cuda_runtime", "cudaLaunchKernel", 3, correlation=502, **{"External id": 7}),
    _x("cuda_runtime", "cudaMemsetAsync", 3, correlation=504, **{"External id": 9}),
    _x("kernel", "bounce_kernel<1>", 10, correlation=501, **{"External id": 0}),
    _x("kernel", "bounce_kernel<1>", 20, correlation=503),
    _x("kernel", "index_add_kernel", 30, correlation=502, **{"External id": 7}),
    _x("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 40, correlation=505,
       **{"External id": 8}),
    _x("gpu_memset", "Memset (Device)", 5, correlation=504),
    {"ph": "f", "cat": "ac2g", "name": "ac2g", "id": 502, "pid": 0, "tid": 1, "ts": 0.0},
]


def _write(dirname, name, events):
    os.makedirs(dirname, exist_ok=True)
    path = os.path.join(dirname, name)
    with open(path, "w") as f:
        json.dump({"traceEvents": events}, f)
    return path


def test_synthetic_trace_totals(tmp_path):
    _write(tmp_path, "trace_20260101_000000_1.json", SYNTHETIC)
    rep = trace_report.report(str(tmp_path))
    assert rep["trace"] == "trace_20260101_000000_1.json"
    assert rep["device_total_s"] == 105 / 1e6
    assert rep["by_kernel"] == {"Memcpy DtoH (Device -> Pinned)": 40 / 1e6,
                                "bounce_kernel<1>": 30 / 1e6, "index_add_kernel": 30 / 1e6,
                                "Memset (Device)": 5 / 1e6}
    assert rep["by_category"] == {"kernel": 60 / 1e6, "gpu_memcpy": 40 / 1e6,
                                  "gpu_memset": 5 / 1e6}
    assert rep["by_launcher"] == {"aten::copy_": 40 / 1e6, "?": 30 / 1e6,
                                  "aten::index_add_": 30 / 1e6, "aten::zero_": 5 / 1e6}
    top = trace_report.report(str(tmp_path), top=1)
    assert top["by_kernel"] == {"Memcpy DtoH (Device -> Pinned)": 40 / 1e6}
    assert top["device_total_s"] == rep["device_total_s"]


def test_newest_trace_is_read(tmp_path):
    old = _write(tmp_path, "trace_a.json", SYNTHETIC)
    new = _write(tmp_path, "trace_b.json", SYNTHETIC[:1] + [_x("kernel", "k", 7)])
    os.utime(old, (1_000_000, 1_000_000))
    os.utime(new, (2_000_000, 2_000_000))
    rep = trace_report.report(str(tmp_path))
    assert rep["trace"] == "trace_b.json" and rep["by_kernel"] == {"k": 7 / 1e6}


def test_real_cpu_trace_parses(tmp_path, capsys):
    with trace(str(tmp_path)):
        x = torch.randn(64, 64)
        (x @ x).sum()
    rep = trace_report.report(str(tmp_path))
    assert rep["trace"].startswith("trace_") and rep["device_total_s"] == 0.0
    assert rep["by_kernel"] == {} and rep["by_launcher"] == {}
    assert trace_report.main([str(tmp_path), "--top", "3"]) == 0
    assert json.loads(capsys.readouterr().out) == rep


def test_no_trace_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="no trace"):
        trace_report.report(str(tmp_path))
