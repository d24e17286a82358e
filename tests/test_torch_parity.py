"""rtweekend_tpu_torch.tools.parity and the image readers it uses.

- `compare` equals the root parity.compare on seeded images, and the
  BASELINE configs are the same tuple;
- read_png / read_ppm equal Pillow on the four committed TPU artifacts,
  and decode rows written with each PNG filter type;
- BASELINE config 1 rendered by the port on the CPU against the JAX
  package's TPU render of it (artifacts/, named by parity_report.json):
  at most 0.5% of pixels off by more than 2 of 255 levels (0.070%
  measured), channel means within 0.002, every 3x3 region within 0.005;
  the committed artifacts and report are byte-for-byte unchanged after;
- main's golden comparison, `--golden none`, a missing golden, and
  `--golden` required (it has no default);
- `--against-plain`: each config traced again by the plain version.

Run as a script (`PYTHONPATH=. JAX_PLATFORMS=cpu python
tests/test_torch_parity.py N`), it traces N sampled pixels of config 4
(final_scene 1200x675, 100 spp) with the port's plain version and with the
JAX package's own jnp integrator on the CPU, and prints each one's pixel
statistics against the TPU render and against each other: the measurement
behind config 4's bar in tools/parity.py.
"""

import hashlib
import json
import os
import struct
import zlib

import numpy as np
import pytest

import parity as jax_parity
from rtweekend_tpu_torch.tools import parity
from rtweekend_tpu_torch.utils import image as image_mod

from test_torch_megakernel import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACTS = sorted(os.path.join(REPO, "artifacts", f)
                   for f in os.listdir(os.path.join(REPO, "artifacts")))


def _committed_hashes():
    paths = ARTIFACTS + [os.path.join(REPO, "parity_report.json")]
    return {p: hashlib.sha256(open(p, "rb").read()).hexdigest() for p in paths}


@pytest.mark.parametrize("case", ["identical", "shifted", "noisy"])
def test_compare_equals_jax(case):
    rng = np.random.default_rng(7)
    ours = rng.random((45, 60, 3))
    golden = {"identical": ours.copy(),
              "shifted": np.clip(np.roll(ours, 3, axis=1) + 0.05, 0.0, 1.0),
              "noisy": rng.random((45, 60, 3))}[case]
    assert parity.compare(ours, golden) == jax_parity.compare(ours, golden)


def test_baseline_configs_equal():
    assert parity.BASELINE_CONFIGS == jax_parity.BASELINE_CONFIGS


@pytest.mark.parametrize("path", ARTIFACTS, ids=os.path.basename)
def test_readers_match_pillow(path):
    Image = pytest.importorskip("PIL.Image")
    want = np.asarray(Image.open(path).convert("RGB"))
    got = image_mod.read_rgb(path)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _encode_png(path, img, filters):
    """A PNG of uint8 img [H, W, bpp] whose row r is written with filter
    filters[r % len(filters)], encoded byte by byte (PNG spec §9)."""
    h, w, bpp = img.shape
    raw = img.astype(np.int64).reshape(h, w * bpp)
    out = []
    for r in range(h):
        ft = filters[r % len(filters)]
        row = [ft]
        for x in range(w * bpp):
            a = raw[r, x - bpp] if x >= bpp else 0
            b = raw[r - 1, x] if r > 0 else 0
            c = raw[r - 1, x - bpp] if r > 0 and x >= bpp else 0
            pred = (0, a, b, (a + b) // 2, _paeth(a, b, c))[ft]
            row.append((raw[r, x] - pred) & 0xFF)
        out.append(bytes(row))
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2 if bpp == 3 else 6, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(image_mod._png_chunk(b"IHDR", ihdr))
        f.write(image_mod._png_chunk(b"IDAT", zlib.compress(b"".join(out))))
        f.write(image_mod._png_chunk(b"IEND", b""))


@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,), (4, 0, 3, 1, 2)],
                         ids=["none", "sub", "up", "average", "paeth", "mixed"])
@pytest.mark.parametrize("bpp", [3, 4])
def test_read_png_filter_types(tmp_path, filters, bpp):
    rng = np.random.default_rng(len(filters) * 10 + filters[0] + bpp)
    img = rng.integers(0, 256, (7, 9, bpp), dtype=np.uint8)
    img[2:5, 2:6] = 250        # flat patches make the predictors tie
    path = tmp_path / "f.png"
    _encode_png(path, img, filters)
    np.testing.assert_array_equal(image_mod.read_png(path), img[..., :3])


@pytest.mark.parametrize("writer", ["write_png", "minimal"])
def test_png_round_trip(tmp_path, writer):
    img = np.random.default_rng(3).integers(0, 256, (31, 17, 3), dtype=np.uint8)
    path = tmp_path / "rt.png"
    if writer == "write_png":
        image_mod.write_png(path, img)
    else:
        image_mod._write_png_minimal(path, img)
    np.testing.assert_array_equal(image_mod.read_png(path), img)


def test_ppm_p3_and_p6(tmp_path):
    img = np.random.default_rng(5).integers(0, 256, (6, 11, 3), dtype=np.uint8)
    p3 = tmp_path / "a.ppm"
    image_mod.write_ppm(p3, img)
    np.testing.assert_array_equal(image_mod.read_ppm(p3), img)
    p6 = tmp_path / "b.ppm"
    p6.write_bytes(b"P6\n# a comment\n11 6\n255\n" + img.tobytes())
    np.testing.assert_array_equal(image_mod.read_rgb(p6), img)


def test_config1_against_tpu(tmp_path, monkeypatch):
    """BASELINE config 1 through main on the CPU, held against the TPU's PPM."""
    before = _committed_hashes()
    monkeypatch.setattr(parity, "BASELINE_CONFIGS", parity.BASELINE_CONFIGS[:1])
    out = tmp_path / "report.json"
    assert parity.main(["--configs", "--golden", "none", "--cpu", "--out", str(out),
                        "--artifacts-out", str(tmp_path / "art"), "--against-plain"]) == 0
    report = json.loads(out.read_text())
    assert report["golden"] == "not compared (--golden none)"
    row = report["baseline_configs"]["config1_book1_diffuse"]
    vs = row["vs_tpu"]
    print(json.dumps(vs))
    assert row["backend"] == "cpu" and row["finite"]
    assert row["artifact"].startswith(str(tmp_path))
    assert vs["pixels_off_by_gt2_frac"] <= parity.OFF2_FRAC["config1_book1_diffuse"]
    assert vs["channel_mean_max_abs_diff"] <= parity.MEAN_TOL
    assert max(vs["region_mean_abs_diff"].values()) <= parity.REGION_TOL
    assert vs["within_bars"] and vs["max_diff"] <= 255
    # on the CPU the render is the plain version: --against-plain traces
    # the same image again, and its distance from the TPU is vs_tpu's
    plain = row["vs_plain"]
    assert plain["rows"] == [0, row["height"]] and plain["plain_s"] > 0
    assert plain["image_vs_plain"]["pixels_differ_frac"] == 0.0
    assert plain["plain_vs_tpu"] == plain["image_vs_tpu"]
    assert plain["image_vs_tpu"]["pixels_off_by_gt2_frac"] == vs["pixels_off_by_gt2_frac"]
    assert _committed_hashes() == before
    assert all(parity.tpu_artifacts_unchanged().values())


def test_band_against_plain():
    """band_against_plain on config 1 with the TPU's own image as the row's:
    the image agrees with the TPU exactly, and its distance from the plain
    version is the plain version's from the TPU."""
    key, name, w, h, spp, depth, _ = parity.BASELINE_CONFIGS[0]
    tpu = image_mod.read_rgb(parity.tpu_rows()[key]["artifact"])
    row = dict(scene=name, width=w, height=h, spp=spp, max_depth=depth, image=tpu)
    band = parity.band_against_plain(key, row, 40, 52, device="cpu")
    assert band["rows"] == [40, 52]
    assert band["image_vs_tpu"]["pixels_differ_frac"] == 0.0
    assert band["image_vs_plain"] == band["plain_vs_tpu"]
    assert band["plain_vs_tpu"]["pixels_off_by_gt2_frac"] <= parity.OFF2_FRAC[key]


def test_golden_comparison(tmp_path):
    """main against a small stand-in golden: the metrics are compare() of
    the render (--save-png) and the golden."""
    golden = np.random.default_rng(11).integers(0, 256, (20, 30, 3), dtype=np.uint8)
    gpath = tmp_path / "golden.png"
    image_mod.write_png(gpath, golden)
    out, ours_path = tmp_path / "r.json", tmp_path / "ours.png"
    assert parity.main(["--golden", str(gpath), "--spp", "1", "--cpu", "--out", str(out),
                        "--save-png", str(ours_path)]) == 0
    report = json.loads(out.read_text())
    ours = image_mod.read_png(ours_path)
    assert ours.shape == golden.shape
    assert report["metrics"] == jax_parity.compare(ours / 255.0, golden / 255.0)
    assert report["config"]["width"] == 30 and report["config"]["height"] == 20


def test_golden_required(tmp_path, capsys):
    """--golden has no default: the reference's golden lies outside the
    checkout, so a caller must name it or say none."""
    with pytest.raises(SystemExit) as exc:
        parity.main(["--configs", "--cpu", "--out", str(tmp_path / "r.json")])
    assert exc.value.code == 2
    assert "--golden" in capsys.readouterr().err
    assert not (tmp_path / "r.json").exists()


def test_missing_golden_raises(tmp_path):
    missing = str(tmp_path / "nope.png")
    with pytest.raises(FileNotFoundError, match="nope.png"):
        parity.main(["--golden", missing, "--cpu", "--out", str(tmp_path / "r.json")])
    assert not (tmp_path / "r.json").exists()


def config4_sample(n_pixels: int, *, with_jax: bool, chunk: int = 200, seed: int = 0):
    """BASELINE config 4 (final_scene 1200x675, 100 spp, depth 50, seed 42)
    at n_pixels pixels drawn without replacement (numpy seed `seed`),
    traced on the CPU by the port's plain version and, with_jax, by the
    JAX package's jnp integrator (jitted), each tone mapped; and the TPU
    artifact's pixels. Returns (pixel ids, port, jax or None, tpu) as
    uint8 [n, 3]. The counter RNG keys every draw by (seed, pixel,
    sample), so a pixel's samples are the full render's."""
    import torch

    from rtweekend_tpu_torch.models.builders import build_scene
    from rtweekend_tpu_torch.ops.camera import generate_rays
    from rtweekend_tpu_torch.ops.cuda import megakernel as mk
    from rtweekend_tpu_torch.render import camera_for_scene

    _, name, w, h, spp, depth, _ = parity.BASELINE_CONFIGS[3]
    bg = (0.7, 0.8, 1.0)
    pix = np.sort(np.random.default_rng(seed).choice(w * h, n_pixels, replace=False))
    tpu = image_mod.read_rgb(parity.tpu_rows()["config4_final_scene"]["artifact"])
    tpu_px = tpu[h - 1 - pix // w, pix % w]
    tables = mk.pack_scene(build_scene(name, seed=42, device="cpu"))
    cam = camera_for_scene(name, w / h, "cpu")
    if with_jax:
        import jax
        import jax.numpy as jnp

        from rtweekend_tpu.models.builders import build_scene as jax_build_scene
        from rtweekend_tpu.ops.camera import generate_rays as jax_generate_rays
        from rtweekend_tpu.ops.integrator import trace_paths as jax_trace_paths
        from rtweekend_tpu.render import camera_for_scene as jax_camera_for_scene

        jscene = jax_build_scene(name, seed=42)
        jcam = jax_camera_for_scene(name, aspect_ratio=w / h)
        jtrace = jax.jit(lambda o, d, t, p, s: jax_trace_paths(
            jscene, o, d, t, p, s, jnp.uint32(42), jnp.asarray(bg, jnp.float32), depth))

    def tone(sums):
        return np.floor(256 * np.clip(np.sqrt(sums / spp), 0.0, 0.999)).astype(np.uint8)

    port, jx = [], []
    for i in range(0, n_pixels, chunk):
        p = pix[i:i + chunk].astype(np.int32)
        pid = np.repeat(p, spp)
        sid = np.tile(np.arange(spp, dtype=np.int32), len(p))
        tp, ts = torch.from_numpy(pid), torch.from_numpy(sid)
        o, d, t = generate_rays(cam, w, h, tp, ts, 42)
        rad = mk.trace_paths(tables, o, d, t, tp, ts, 42, bg, depth, kernel="torch")
        port.append(rad.numpy().reshape(len(p), spp, 3).sum(1))
        if with_jax:
            jp, js = jnp.asarray(pid), jnp.asarray(sid)
            rj = jtrace(*jax_generate_rays(jcam, w, h, jp, js, jnp.uint32(42)), jp, js)
            jx.append(np.asarray(rj).reshape(len(p), spp, 3).sum(1))
    return (pix, tone(np.concatenate(port)), tone(np.concatenate(jx)) if with_jax else None,
            tpu_px)


def _sample_stats(a, b):
    """pixel_stats of two [n, 3] pixel lists, as [n, 1, 3] images."""
    return parity.pixel_stats(a[:, None], b[:, None])


if __name__ == "__main__":
    # PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_parity.py [n_pixels]
    # prints, for n_pixels sampled pixels of config 4, the port's plain
    # version and the JAX package's own CPU render (jnp integrator) each
    # against the TPU artifact, and against each other
    import sys
    import time

    t0 = time.time()
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 2000
    _, port, jx, tpu = config4_sample(n, with_jax=True)
    print(json.dumps({"n_pixels": n, "port_plain_cpu_vs_tpu": _sample_stats(port, tpu),
                      "jax_cpu_vs_tpu": _sample_stats(jx, tpu),
                      "port_plain_cpu_vs_jax_cpu": _sample_stats(port, jx),
                      "seconds": time.time() - t0}))
