"""Build a shared library at first use, once per toolchain, flags and source.

The library is named by a hash of the compiler's `--version` output, the
flags and the sources, so a build directory carried to a machine with
another toolchain is rebuilt there, never loaded. Concurrent processes
each compile into a temporary file and move it into place. A failed build
raises with the compiler's output and leaves no library behind.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile
import time
from pathlib import Path


def _run(cmd) -> subprocess.CompletedProcess:
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"cannot run the compiler: {' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"compiler failed ({proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    return proc


def build_shared(compiler: str, flags, sources, out_dir: Path,
                 stem: str) -> tuple[Path, float, str]:
    """(library path, compile seconds or 0.0 when it was already built,
    compiler output)."""
    h = hashlib.sha256(_run([compiler, "--version"]).stdout.encode())
    h.update(" ".join(flags).encode())
    for s in sources:
        h.update(Path(s).read_bytes())
    out = out_dir / f"{stem}_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out, 0.0, ""
    out_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = _run([compiler, *flags, "-o", tmp, *map(str, sources)])
    except RuntimeError:
        os.unlink(tmp)
        raise
    seconds = time.perf_counter() - t0
    os.replace(tmp, out)
    return out, seconds, proc.stdout + proc.stderr
