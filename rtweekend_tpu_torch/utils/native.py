"""Host image runtime: PNG and PPM encoding in C++.

The port's counterpart of `rtweekend_tpu.utils.native`, with its own
source, `csrc/rtw_native.cpp`. The host C++ compiler (`c++` or `g++` on
PATH) builds it with `-O3 -shared -fPIC` into `build/native/` beside the
package, named by a hash of the compiler's version, the flags and the
source, at the first call; later calls reuse it. It is loaded with
ctypes. Nothing runs at import time; a failed build raises with the
compiler's output, and nothing falls back.

A PNG is the Paeth-filtered rows from the library, deflated by Python's
zlib at level 6 and wrapped in IHDR, IDAT and IEND: the bytes the JAX
package's native encoder writes. The plain versions beside the native
ones (`png_filter_plain`, `png_encode_plain`, `ppm_encode_plain`) are the
references the tests and the card's smoke run hold them to.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import shutil
import struct
import zlib
from pathlib import Path

import numpy as np

from rtweekend_tpu_torch.utils.shlib import build_shared

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "rtw_native.cpp"
BUILD_DIR = _PKG.parent / "build" / "native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
PNG_DEFLATE_LEVEL = 6   # the JAX package's native encoder's level


@dataclasses.dataclass(frozen=True)
class Built:
    path: Path
    compiler: str
    seconds: float   # compile time; 0.0 when the library was already built


def _cxx() -> str:
    found = shutil.which("c++") or shutil.which("g++")
    if not found:
        raise RuntimeError("no host C++ compiler: put c++ or g++ on PATH")
    return found


def build() -> Built:
    """Compile SOURCE into BUILD_DIR unless a library of this compiler,
    these flags and this source is there (utils/shlib.py)."""
    cxx = _cxx()
    out, seconds, _ = build_shared(cxx, CXX_FLAGS, [SOURCE], BUILD_DIR, "rtw_native")
    return Built(out, cxx, seconds)


@functools.cache
def load():
    """(ctypes library with argtypes set, Built record); builds at first
    call, and raises if the build fails."""
    built = build()
    lib = ctypes.CDLL(str(built.path))
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    lib.rtw_png_filter.argtypes = [p, i32, i32, p]
    lib.rtw_png_filter.restype = None
    lib.rtw_ppm_encode.argtypes = [p, i32, i32, p, i64]
    lib.rtw_ppm_encode.restype = i64
    return lib, built


def _rgb(img) -> np.ndarray:
    img = np.ascontiguousarray(np.asarray(img), dtype=np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected uint8 RGB [H, W, 3], got shape {img.shape}")
    return img


def png_filter(img) -> bytes:
    """The Paeth-filtered scanlines (filter byte 4 a row) of uint8 RGB
    [H, W, 3]: H * (1 + 3W) bytes."""
    lib, _ = load()
    img = _rgb(img)
    h, w, _ = img.shape
    out = np.empty(h * (1 + 3 * w), dtype=np.uint8)
    lib.rtw_png_filter(img.ctypes.data, w, h, out.ctypes.data)
    return out.tobytes()


def png_filter_plain(img) -> bytes:
    """numpy version of `png_filter`."""
    img = _rgb(img)
    h, w, _ = img.shape
    x = img.reshape(h, 3 * w).astype(np.int32)
    a = np.zeros_like(x)
    a[:, 3:] = x[:, :-3]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, 3:] = x[:-1, :-3]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    rows = np.empty((h, 1 + 3 * w), dtype=np.uint8)
    rows[:, 0] = 4
    rows[:, 1:] = (x - pred) & 0xFF
    return rows.tobytes()


def _png_chunk(tag, data):
    chunk = tag + data
    return struct.pack(">I", len(data)) + chunk + struct.pack(
        ">I", zlib.crc32(chunk) & 0xFFFFFFFF
    )


def _png(rows: bytes, w: int, h: int) -> bytes:
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)   # 8-bit RGB
    return (PNG_SIGNATURE + _png_chunk(b"IHDR", ihdr)
            + _png_chunk(b"IDAT", zlib.compress(rows, PNG_DEFLATE_LEVEL))
            + _png_chunk(b"IEND", b""))


def png_encode(img) -> bytes:
    """uint8 RGB [H, W, 3] -> PNG file bytes, rows Paeth-filtered in C++."""
    img = _rgb(img)
    h, w, _ = img.shape
    return _png(png_filter(img), w, h)


def png_encode_plain(img) -> bytes:
    """numpy version of `png_encode`."""
    img = _rgb(img)
    h, w, _ = img.shape
    return _png(png_filter_plain(img), w, h)


def ppm_encode(img) -> bytes:
    """uint8 RGB [H, W, 3] -> P3 PPM file bytes, written in C++."""
    lib, _ = load()
    img = _rgb(img)
    h, w, _ = img.shape
    cap = 12 * w * h + 32
    out = np.empty(cap, dtype=np.uint8)
    n = lib.rtw_ppm_encode(img.ctypes.data, w, h, out.ctypes.data, cap)
    if n < 0:
        raise RuntimeError(f"rtw_ppm_encode: {cap} bytes too few for {w}x{h}")
    return out[:n].tobytes()


def ppm_encode_plain(img) -> bytes:
    """Python version of `ppm_encode`."""
    arr = _rgb(img)
    h, w, _ = arr.shape
    lines = [f"P3\n{w} {h}\n255\n"]
    lines.extend(f"{r} {g} {b}\n" for r, g, b in arr.reshape(-1, 3))
    return "".join(lines).encode()
