"""Build and load the hand-written CUDA kernels.

`nvcc` compiles `csrc/*.cu` for sm_90a into a shared library with a
plain C interface, loaded with ctypes. The library lands in
`build/kernels/` beside the package, named by a hash of the sources and
flags, so the first call in a fresh checkout builds it (seconds) and
later calls reuse it. Nothing here runs at import time; a failed build
raises and is never caught on the way to the caller.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
SOURCES = ("megakernel.cu",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclasses.dataclass(frozen=True)
class Built:
    path: Path
    seconds: float   # compile time; 0.0 when the library was already built
    log: str         # nvcc/ptxas output (registers, shared memory, spills)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cand = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    found = cand if cand and os.path.exists(cand) else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def build() -> Built:
    srcs = [CSRC / s for s in SOURCES]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.read_bytes())
    out = BUILD_DIR / f"rtw_kernels_{h.hexdigest()[:16]}.so"
    if out.exists():
        return Built(out, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, srcs)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
    os.replace(tmp, out)
    return Built(out, seconds, log)


@functools.cache
def load():
    """(ctypes library with argtypes set, Built record)."""
    built = build()
    lib = ctypes.CDLL(str(built.path))
    p, i, u, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
    lib.rtw_bounce_segment.argtypes = [
        p, i, i,        # coef, n_rows, coef_stride
        p, p, i,        # attr_f, attr_i, attr_stride
        i, i, i,        # s_pad, r_pad, variant mask
        p, p, p,        # perm, grad, images
        p, p, p, p, i,  # state_in, state_out, rad, winners (or None), m
        u, f, f, f,     # seed, background rgb (the gradient sky's bottom)
        f, f, f,        # the gradient sky's top
        i, i, f,        # b0, n_bounces, t_min
        p,              # stream
    ]
    lib.rtw_bounce_segment.restype = ctypes.c_int
    lib.rtw_error_string.argtypes = [ctypes.c_int]
    lib.rtw_error_string.restype = ctypes.c_char_p
    return lib, built
