"""Nothing the benchmark runs on the card imports JAX or the JAX package,
and the reference imports nothing of the program. Top-level module names
are compared whole: rtweekend_tpu_torch is not rtweekend_tpu."""

import ast
import types
from pathlib import Path

import pytest

from benchmark import harness

BENCH = Path(__file__).resolve().parents[1]


def _imports(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


REFERENCE = sorted((BENCH / "reference").glob("*.py"))
HARNESS = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", REFERENCE, ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not _imports(path) & {"rtweekend_tpu_torch", "rtweekend_tpu", "jax", "jaxlib", "flax"}


@pytest.mark.parametrize("path", HARNESS, ids=lambda p: str(p.relative_to(BENCH)))
def test_harness_imports_no_jax(path):
    assert not _imports(path) & {"rtweekend_tpu", "jax", "jaxlib", "flax"}


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    fake = types.SimpleNamespace(modules={"rtweekend_tpu_torch": 0, "rtweekend_tpu_torch.render": 0,
                                          "jaxtyping": 0, "flaxen.x": 0})
    monkeypatch.setattr(harness, "sys", fake)
    assert harness.forbidden_modules() == []
    fake.modules.update({"jax.numpy": 0, "rtweekend_tpu.render": 0})
    assert harness.forbidden_modules() == ["jax", "rtweekend_tpu"]
