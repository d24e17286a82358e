"""rtweekend_tpu_torch.tools.bench_scenes and tools.bench on the CPU.

The scene list equals the root bench_scenes.py's, and the roofline's
lane-bounce count equals bench.py's `_executed_lane_bounces` (taken from
bench.py's source, not imported: bench.py configures JAX's cache and logs
when it is imported). Both mains run at tiny sizes (their module constants
patched) with their JSON lines checked; bench's live ray-bounces equal a
count over the whole render in one batch.
"""

import ast
import json
import math
import os

import pytest

from rtweekend_tpu_torch.ops.cuda import megakernel as mk
from rtweekend_tpu_torch.tools import bench, bench_scenes
from rtweekend_tpu_torch.utils import roofline

from test_torch_megakernel import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _root_module_ast(name):
    with open(os.path.join(REPO, name)) as f:
        return ast.parse(f.read())


def _jax_executed_lane_bounces():
    """bench.py's _executed_lane_bounces, compiled from its source (it
    imports the JAX package's _tiles when called)."""
    tree = _root_module_ast("bench.py")
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == "_executed_lane_bounces")
    ns = {}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), "bench.py", "exec"), ns)
    return ns["_executed_lane_bounces"]


def test_bench_scenes_configs_equal():
    tree = _root_module_ast("bench_scenes.py")
    node = next(n for n in tree.body if isinstance(n, ast.Assign)
                and any(getattr(t, "id", None) == "CONFIGS" for t in n.targets))
    assert bench_scenes.CONFIGS == ast.literal_eval(node.value)


@pytest.mark.parametrize("caps", [mk.CAPS_OPEN, mk.CAPS_CLOSED,
                                  ((3, 0.533), (5, 0.190), (8, 0.0571), (15, 0.0156)), ()],
                         ids=["open", "closed", "adaptive", "none"])
@pytest.mark.parametrize("n_rays,n_batches,depth", [(4_050_000, 8, 50), (811_008, 3, 16),
                                                    (1000, 2, 4)])
def test_executed_lane_bounces_equal_jax(caps, n_rays, n_batches, depth):
    want = _jax_executed_lane_bounces()(n_rays, n_batches, depth, caps)
    assert bench._executed_lane_bounces(n_rays, n_batches, depth, caps) == want


def test_march_flop():
    assert roofline.coef_rows(486, 0) == 972
    assert roofline.march_flop(486, 0) == 2 * 17 * 972 + 2 * 486
    assert roofline.march_flop(0, 6) == 2 * 17 * 36


def _json_lines(text):
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


def test_bench_scenes_main_cpu(monkeypatch, capsys):
    monkeypatch.setattr(bench_scenes, "CONFIGS",
                        [(name, 16, 12, 2, 4) for name, *_ in bench_scenes.CONFIGS])
    assert bench_scenes.main(["--cpu"]) == 0
    out = capsys.readouterr().out
    assert out.splitlines()[0] == "cpu"
    rows = _json_lines(out)
    assert [r["scene"] for r in rows] == [c[0] for c in bench_scenes.CONFIGS]
    for r in rows:
        assert r["size"] == "16x12" and r["spp"] == 2 and r["depth"] == 4
        assert r["rays_per_s"] > 0 and r["exec_s"] > 0 and r["warm_s"] > 0
        assert r["launches"] == 0 and r["card"] == "cpu"   # the plain version on the CPU


def _live_ray_bounces_one_batch(w, h, spp, depth):
    """Live ray-bounces of bench's render at w x h, spp, depth, counted over
    all its rays in one batch through the plain version (the count does not
    depend on how the samples are batched)."""
    import torch

    from rtweekend_tpu_torch.models.builders import build_scene
    from rtweekend_tpu_torch.ops.camera import generate_rays
    from rtweekend_tpu_torch.render import camera_for_scene

    tables = mk.pack_scene(build_scene("final_scene", device="cpu"))
    cam = camera_for_scene("final_scene", w / h, "cpu")
    pid = torch.arange(w * h, dtype=torch.int32).repeat_interleave(spp)
    sid = torch.arange(spp, dtype=torch.int32).repeat(w * h)
    state = mk.init_state(*generate_rays(cam, w, h, pid, sid, 42), pid, sid)
    total = torch.zeros((3, state.shape[0]))   # not read
    live = 0
    for b in range(depth):
        live += int((state[:, mk.S_AL] > 0.5).sum())
        state = mk.trace_segment_plain(tables, state, 42, bench.BACKGROUND, b, 1, accum=total)
    return live


def test_bench_main_cpu(monkeypatch, capsys):
    monkeypatch.setattr(bench, "WIDTH", 24)
    monkeypatch.setattr(bench, "HEIGHT", 12)
    monkeypatch.setattr(bench, "SPP_MEASURE", 4)
    monkeypatch.setattr(bench, "MAX_DEPTH", 4)
    monkeypatch.setattr(bench, "RAYS_PER_CHUNK", 24 * 12 * 2)
    monkeypatch.setattr(bench, "FWD_BWD", (12, 8, 2, 3, 7))
    assert bench.main(["--cpu"]) == 0
    head, full = _json_lines(capsys.readouterr().out)
    assert head == {k: full[k] for k in head}
    assert head["metric"] == "rays_per_s_cpu_final_scene_24x12"
    assert head["unit"] == "primary_rays/s" and head["card"] == "cpu"
    assert head["value"] > 0 and head["exec_s"] > 0 and head["warm_s"] > 0
    caps = bench.adaptive_capacities("final_scene", bench.BACKGROUND, 4)
    lanes = _jax_executed_lane_bounces()(24 * 12 * 2, 2, 4, caps)
    assert full["executed_lane_bounces"] == lanes
    assert full["spheres"] == 486 and full["rects"] == 0
    live = _live_ray_bounces_one_batch(24, 12, 4, 4)
    assert full["live_ray_bounces"] == live
    assert 24 * 12 * 4 <= live <= 24 * 12 * 4 * 4
    assert full["flop_per_ray"] == live * roofline.march_flop(486, 0) / (24 * 12 * 4)
    assert full["sol_rays_per_s"] == round(roofline.FP32_FLOPS / full["flop_per_ray"])
    assert full["pct_of_sol"] == "not measured"
    assert math.isfinite(full["fwd_bwd_rays_per_s"]) and full["fwd_bwd_rays_per_s"] > 0
