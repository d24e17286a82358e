"""rtweekend_tpu_torch end to end on the CPU: render_image against the JAX
package's render_image, the CLI, device selection, and import hygiene.

The JAX render on the CPU runs its jnp integrator, the port its plain
bounce version: the same RNG streams and formulas in other summation
orders, so a rare ray's path diverges (tests/test_pallas.py's bars).
Tone-mapped channel means must agree within 2%."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from rtweekend_tpu.config import RenderConfig as JaxRenderConfig
from rtweekend_tpu.render import render_image as jax_render_image
from rtweekend_tpu_torch import cli
from rtweekend_tpu_torch.config import RenderConfig
from rtweekend_tpu_torch.models.builders import build_scene
from rtweekend_tpu_torch.render import camera_for_scene, render, render_image

from test_torch_megakernel import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name", ["final_scene", "cornell_box", "two_perlin_spheres",
                                  "golden_scene"])
def test_render_image_matches_jax(name):
    kw = dict(scene=name, width=24, height=24, samples_per_pixel=4, max_depth=6)
    want, _ = jax_render_image(JaxRenderConfig(**kw))
    got, accum = render_image(RenderConfig(**kw), device="cpu")
    assert got.shape == (24, 24, 3) and got.dtype == np.uint8
    assert torch.isfinite(accum).all()
    np.testing.assert_allclose(
        got.reshape(-1, 3).mean(0), np.asarray(want).reshape(-1, 3).mean(0), rtol=0.02
    )


def test_render_recovers_compaction_overflow():
    """An overflowing schedule is re-traced uncompacted, never dropped: the
    frame of the render with no compaction (one segment a batch)."""
    scene = build_scene("cornell_box", device="cpu")
    cam = camera_for_scene("cornell_box", 1.0, device="cpu")
    bg = (0.0, 0.0, 0.0)
    fb = render(scene, cam, 16, 16, 4, 6, bg, 42, capacities=((2, 0.1),))
    want = render(scene, cam, 16, 16, 4, 6, bg, 42, capacities=())
    assert torch.isfinite(fb).all()
    torch.testing.assert_close(fb, want, rtol=1e-5, atol=1e-6)


def test_cli_writes_png(tmp_path):
    out = tmp_path / "cornell.png"
    rc = cli.main(["cornell_box", "--width", "16", "--height", "16", "--spp", "2",
                   "--max-depth", "4", "--cpu", "--ppm", "-o", str(out)])
    assert rc == 0
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert (tmp_path / "cornell.ppm").read_text().startswith("P3\n16 16\n255\n")


@pytest.mark.parametrize("flags,message", [
    (["--dtype", "float64", "--kernel", "cuda"], "float32 only"),
    (["--dtype", "float64", "--kernel", "torch"], "float32 only"),
    (["--kernel", "pallas"], "invalid choice"),
    (["--kernel", "jnp"], "invalid choice"),
    (["--dtype", "float16"], "invalid choice"),
])
def test_cli_refuses_unported_flags(flags, message, capsys):
    """What the port does not run is refused with a message: float64 on
    the float32 bounce kernel (never downcast), and the JAX package's
    kernel names (here: cuda, torch, eager)."""
    with pytest.raises(SystemExit) as exc:
        cli.main(["cornell_box", "--cpu", *flags])
    assert exc.value.code == 2
    assert message in capsys.readouterr().err


def test_cli_writes_png_of_a_noise_scene(tmp_path):
    out = tmp_path / "perlin.png"
    rc = cli.main(["two_perlin_spheres", "--width", "12", "--height", "8", "--spp", "2",
                   "--max-depth", "4", "--cpu", "-o", str(out)])
    assert rc == 0
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_entry_points_need_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = RenderConfig(scene="cornell_box", width=8, height=8, samples_per_pixel=1,
                       max_depth=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        render_image(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_scene("cornell_box")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["cornell_box", "--width", "8", "--height", "8", "--spp", "1"])


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every module of rtweekend_tpu_torch, imported in a fresh process."""
    code = r"""
import importlib, pkgutil, sys
import rtweekend_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith(("jax.", "jaxlib"))
             or k == "rtweekend_tpu" or k.startswith("rtweekend_tpu."))
assert len(names) >= 15, names
assert not bad, bad
print(len(names))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
