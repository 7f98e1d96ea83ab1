"""Build-at-first-use loader shared by every CUDA kernel of the port.

Each kernel is one ``.cu`` file with a plain C entry point.  It is
compiled with ``nvcc`` for ``sm_90a`` into a shared library under
``build/kernels/`` at the root of the checkout (the file name carries a
hash of the source, so an edited source is rebuilt) and loaded with
``ctypes``.  A failed build raises; nothing falls back to a plain
version.  Nothing here runs at import: the CPU tests import the kernel
modules without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path

__all__ = ["BUILD_DIR", "BuiltLibrary", "build", "find_nvcc"]

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
_ARCH = "arch=compute_90a,code=sm_90a"

# One build per source per process, also when the scheduler's loop
# thread and a caller reach a kernel's first launch together; two
# sources build in parallel.
_LOCK = threading.Lock()
_SOURCE_LOCKS: dict[Path, threading.Lock] = {}
_BUILT: dict[Path, "BuiltLibrary"] = {}


@dataclass(frozen=True)
class BuiltLibrary:
    lib: ctypes.CDLL
    path: Path
    seconds: float  # wall time of the nvcc call (0.0 when reused)
    ptxas: str  # nvcc's -Xptxas -v report (registers, spills, shared memory),
    # also for a reused build


def find_nvcc() -> str:
    """Path of the nvcc that builds the kernels (PATH, then CUDA_HOME)."""
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels cannot be built")


def build(source: Path) -> BuiltLibrary:
    """Compile ``source`` (once per source version) and load it."""
    source = Path(source).resolve()
    with _LOCK:
        lock = _SOURCE_LOCKS.setdefault(source, threading.Lock())
    with lock:
        hit = _BUILT.get(source)
        if hit is not None:
            return hit
        src = source.read_bytes()
        tag = hashlib.sha1(src).hexdigest()[:12]
        out = BUILD_DIR / f"{source.stem}-{tag}.so"
        log = out.with_suffix(".ptxas.txt")  # the report, kept for reuse
        seconds = 0.0
        report = log.read_text() if log.exists() else ""
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [find_nvcc(), "-gencode", _ARCH, "-std=c++17", "-O3",
                   "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
                   "-o", str(tmp), str(source)]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            seconds = time.perf_counter() - t0
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}) building {source.name}:\n"
                    f"{proc.stdout}\n{proc.stderr}"
                )
            report = proc.stderr
            log.write_text(report)
            os.replace(tmp, out)
        built = BuiltLibrary(ctypes.CDLL(str(out)), out, seconds, report)
        _BUILT[source] = built
        return built
