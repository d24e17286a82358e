"""rtweekend_tpu_torch.utils.native, the port's host image runtime.

- its png_encode / ppm_encode reproduce the four committed TPU artifacts
  byte for byte from their pixels;
- the port's write_png / write_ppm files equal the JAX package's, written
  through the JAX package's native library (native/rtw_native.cpp, built
  here into a temporary directory), on shapes of 1x1 to 100x200;
- the native encoders equal their plain versions, also on a
  non-contiguous view;
- the library is named by the compiler's version, so another toolchain
  rebuilds it; a failed build raises, and write_png never goes through Pillow;
- the wheel's package-data ships every source under csrc/.
"""

import fnmatch
import os
import subprocess
import sys
import tomllib

import numpy as np
import pytest

from rtweekend_tpu.utils import image as jax_image
from rtweekend_tpu.utils import native as jax_native
from rtweekend_tpu_torch.utils import image, native

from test_torch_megakernel import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACTS = sorted(os.path.join(REPO, "artifacts", f)
                   for f in os.listdir(os.path.join(REPO, "artifacts")))
SHAPES = [(1, 1), (2, 2), (33, 57), (100, 200)]


def _img(h, w, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


@pytest.fixture(scope="module")
def jax_lib(tmp_path_factory):
    """The JAX package's native library, built into a temporary directory
    (not native/, which tests/test_native.py builds with make) and loaded
    by rtweekend_tpu.utils.native."""
    so = tmp_path_factory.mktemp("jax_native") / "librtw_native.so"
    subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", str(so),
                    os.path.join(REPO, "native", "rtw_native.cpp"), "-lz"],
                   check=True, capture_output=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "_LIB_PATH", str(so))
        mp.setattr(jax_native, "_tried", False)
        mp.setattr(jax_native, "_lib", None)
        assert jax_native.available()
        yield jax_native


@pytest.mark.parametrize("path", ARTIFACTS, ids=os.path.basename)
def test_artifacts_reencode_byte_for_byte(path):
    img = image.read_rgb(path)
    data = native.ppm_encode(img) if path.endswith(".ppm") else native.png_encode(img)
    with open(path, "rb") as f:
        assert data == f.read()


@pytest.mark.parametrize("fmt", ["png", "ppm"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_write_equals_jax_package(jax_lib, tmp_path, shape, fmt):
    img = _img(*shape, seed=shape[0] * 1000 + shape[1])
    ours, theirs = tmp_path / f"ours.{fmt}", tmp_path / f"jax.{fmt}"
    getattr(image, f"write_{fmt}")(ours, img)
    getattr(jax_image, f"write_{fmt}")(str(theirs), img)
    assert ours.read_bytes() == theirs.read_bytes()
    assert (jax_lib.png_encode(img) if fmt == "png" else jax_lib.ppm_encode(img)) \
        == theirs.read_bytes()


@pytest.mark.parametrize("fmt", ["png", "ppm"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_native_equals_plain(shape, fmt):
    img = _img(*shape, seed=shape[0] + shape[1])
    img[: shape[0] // 2, : shape[1] // 2] = 250   # flat patches: predictor ties
    if fmt == "png":
        assert native.png_filter(img) == native.png_filter_plain(img)
        assert native.png_encode(img) == native.png_encode_plain(img)
    else:
        assert native.ppm_encode(img) == native.ppm_encode_plain(img)


def test_non_contiguous_view():
    img = _img(40, 50, seed=3)
    view = img[5:35:2, 3:-4]
    assert not view.flags.c_contiguous
    assert native.png_encode(view) == native.png_encode_plain(np.ascontiguousarray(view))
    assert native.ppm_encode(view) == native.ppm_encode_plain(np.ascontiguousarray(view))


REAL_CXX = native._cxx()


def _fake_cxx(tmp_path, version, compiles=True):
    """A compiler that reports `version` and either forwards to the real
    one or fails to compile."""
    path = tmp_path / f"cxx-{version.replace(' ', '-')}"
    body = f'exec {REAL_CXX} "$@"' if compiles else 'echo "error: broken" >&2; exit 1'
    path.write_text(f'#!/bin/sh\n[ "$1" = --version ] && {{ echo "{version}"; exit 0; }}\n'
                    f"{body}\n")
    path.chmod(0o755)
    return str(path)


def test_toolchain_names_the_library(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    first = {}
    for version in ["cxx 1.0", "cxx 2.0", "cxx 1.0"]:
        monkeypatch.setattr(native, "_cxx", lambda v=version: _fake_cxx(tmp_path, v))
        built = native.build()
        assert (built.seconds > 0) == (version not in first)
        assert first.setdefault(version, built.path) == built.path
    assert first["cxx 1.0"] != first["cxx 2.0"]


@pytest.mark.parametrize("compiler", ["missing", "fails"])
def test_failed_build_raises(monkeypatch, tmp_path, compiler):
    cxx = (str(tmp_path / "no-such-c++") if compiler == "missing"
           else _fake_cxx(tmp_path, "cxx 1.0", compiles=False))
    monkeypatch.setattr(native, "_cxx", lambda: cxx)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    native.load.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="compiler"):
            native.load()
        with pytest.raises(RuntimeError, match="compiler"):
            native.png_encode(_img(2, 2))
        build_dir = tmp_path / "build"
        assert not build_dir.exists() or list(build_dir.iterdir()) == []   # no partial library
    finally:
        native.load.cache_clear()


def test_write_png_never_uses_pillow(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "PIL", None)        # any import of PIL raises
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    img = _img(31, 17, seed=9)
    image.write_png(tmp_path / "a.png", img)
    assert (tmp_path / "a.png").read_bytes() == native.png_encode_plain(img)
    np.testing.assert_array_equal(image.read_png(tmp_path / "a.png"), img)


def test_package_data_ships_sources():
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        globs = tomllib.load(f)["tool"]["setuptools"]["package-data"]["rtweekend_tpu_torch"]
    csrc = os.path.join(REPO, "rtweekend_tpu_torch", "csrc")
    sources = sorted(f"csrc/{f}" for f in os.listdir(csrc))
    assert "csrc/megakernel.cu" in sources and "csrc/rtw_native.cpp" in sources
    for s in sources:
        assert any(fnmatch.fnmatch(s, g) for g in globs), f"{s} is not in the wheel"
