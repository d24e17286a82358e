"""Build and load the hand-written CUDA kernels.

`nvcc` compiles `csrc/*.cu` for sm_90a into a shared library with a
plain C interface, loaded with ctypes. The library lands in
`build/kernels/` beside the package, named by a hash of nvcc's version,
the flags and the sources (utils/shlib.py), so the first call in a fresh
checkout builds it (seconds) and later calls reuse it. Nothing here runs
at import time; a failed build raises and is never caught on the way to
the caller.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import os
import shutil
from pathlib import Path

from rtweekend_tpu_torch.utils.shlib import build_shared

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
    out, seconds, log = build_shared(_nvcc(), NVCC_FLAGS, [CSRC / s for s in SOURCES],
                                     BUILD_DIR, "rtw_kernels")
    return Built(out, seconds, log)


@functools.cache
def load():
    """(ctypes library with argtypes set, Built record)."""
    built = build()
    return bind(ctypes.CDLL(str(built.path))), built


def bind(lib):
    """Set the argument and result types of the library's C entries."""
    p, i, u, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
    lib.rtw_bounce_segment.argtypes = [
        p, i, i,        # coef, n_rows, coef_stride
        p, p, i,        # attr_f, attr_i, attr_stride
        i, i, i, i, i,  # s_pad, r_pad, s_live, r_live, variant mask
        p, p, p,        # perm, grad, images
        p, p, p,        # state_in, state_out, rad (or None)
        p, i,           # accum (or None), accum_cols
        p, i,           # winners (or None), m
        u, f, f, f,     # seed, background rgb (the gradient sky's bottom)
        f, f, f,        # the gradient sky's top
        i, i, f,        # b0, n_bounces, t_min
        i, i, p,        # group, blocks, counter
        p,              # stream
    ]
    lib.rtw_bounce_segment.restype = ctypes.c_int
    lib.rtw_raygen.argtypes = [
        p, i, i,        # state, n, m
        i, i, i, i,     # p0, sample_start, n_samples, width
        f, f, u,        # inv_w, inv_h, seed
        ctypes.POINTER(f), p,  # camera (21 host floats), stream
    ]
    lib.rtw_raygen.restype = ctypes.c_int
    lib.rtw_bounce_blocks_per_sm.argtypes = [i, i, i, ctypes.POINTER(i)]
    lib.rtw_bounce_blocks_per_sm.restype = ctypes.c_int
    lib.rtw_error_string.argtypes = [ctypes.c_int]
    lib.rtw_error_string.restype = ctypes.c_char_p
    return lib
