"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain ``extern "C"`` interface.  It is
compiled with ``nvcc`` for ``sm_90a`` into a shared library under
``build/kernels/`` at the repository root, at first use, and loaded with
``ctypes``.  The library's file name carries a hash of the source and the
flags, so an edited source always rebuilds and an unchanged one loads the
earlier build.  ``-Xptxas -v`` makes ptxas report each kernel's registers,
shared memory and spills; the build keeps that report beside the library
(:func:`build_log`).  Nothing is built when a module is imported.

Every build that really runs ``nvcc`` and every first load of a library
is reported, with its seconds, to the listeners in :data:`LISTENERS`
(``utils/jitcache.py`` counts them).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, List

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
# callables ``fn(kind, seconds)``, kind "build" or "load"
LISTENERS: List[Callable[[str, float], None]] = []
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    """The CUDA compiler: on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels are built from source at first use")


def _notify(kind: str, seconds: float) -> None:
    for fn in list(LISTENERS):
        fn(kind, seconds)


def library_path(name: str, csrc: Path = CSRC) -> Path:
    src = csrc / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(name: str, csrc: Path = CSRC) -> Path:
    """Compile ``<csrc>/<name>.cu`` (this package's sources by default)
    unless that source's library exists; returns the library's path.
    Raises ``RuntimeError`` with nvcc's output when the build fails."""
    out = library_path(name, csrc)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(csrc / f"{name}.cu")]
    t0 = time.monotonic()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu (rc {proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)  # atomic: concurrent builds race safely
    _notify("build", time.monotonic() - t0)
    return out


def build_log(name: str) -> str:
    """What nvcc and ptxas printed when this source's library was built."""
    log = build(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load one kernel library, once per process."""
    path = build(name)
    t0 = time.monotonic()
    lib = ctypes.CDLL(str(path))
    _notify("load", time.monotonic() - t0)
    return lib
