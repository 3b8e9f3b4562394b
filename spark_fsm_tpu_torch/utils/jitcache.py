"""The kernels' build cache and its counter — port of
``spark_fsm_tpu/utils/jitcache.py``.

The reference points JAX's persistent compilation cache at a directory
and counts XLA backend compiles through ``jax.monitoring``.  On a CUDA
card nothing is compiled per shape: each CUDA kernel is one ``nvcc``
build of its source for ``sm_90a`` (``ops/_build.py``), kept on disk
under a name keyed by a hash of the source and flags, and loaded once
per process with ``ctypes``.  So here:

- the counter counts the ``nvcc`` builds that ``_build.build`` really
  runs and the first ``_build.load`` of each library in this process,
  with their seconds (a prewarmed process's first mine builds and loads
  nothing).  On the CPU nothing is ever built or loaded, so the counts
  stay 0;
- the cache is the kernels' build directory (``_build.BUILD_DIR``,
  ``build/kernels`` at the repository root by default): a library built
  by one process is loaded, not rebuilt, by the next.

Env knobs, as in the reference: ``SPARKFSM_COMPILE_CACHE=0`` disables
(:func:`enable_compile_cache` returns None and the kernels keep the
default directory: a library must be a file to be loaded);
``SPARKFSM_COMPILE_CACHE_DIR`` overrides the location.
"""

from __future__ import annotations

import logging
import os
import threading
from pathlib import Path
from typing import Optional

from spark_fsm_tpu_torch.ops import _build

_counter_lock = threading.Lock()
_compile_counter = {"count": 0, "seconds": 0.0}
_counter_registered = False


def _on_event(kind: str, seconds: float) -> None:
    with _counter_lock:
        _compile_counter["count"] += 1
        _compile_counter["seconds"] += float(seconds)


def enable_compile_counter() -> bool:
    """Install the (idempotent, process-wide) build/load listener.
    Always True: the build module reports every event itself."""
    global _counter_registered
    with _counter_lock:
        if not _counter_registered:
            _build.LISTENERS.append(_on_event)
            _counter_registered = True
    return True


def compile_counts() -> dict:
    """Snapshot of the builds plus first loads, and their total seconds,
    since :func:`enable_compile_counter` ran (zeros before)."""
    with _counter_lock:
        return dict(_compile_counter)


def enable_compile_cache(path: Optional[str] = None) -> Optional[str]:
    """Point the kernels' build directory at ``path`` (or
    ``SPARKFSM_COMPILE_CACHE_DIR``, else keep ``_build.BUILD_DIR``).
    Returns the directory in use, or None when disabled.  Never raises:
    an unusable directory leaves the default in place."""
    if os.environ.get("SPARKFSM_COMPILE_CACHE") == "0":
        return None
    path = path or os.environ.get("SPARKFSM_COMPILE_CACHE_DIR")
    try:
        if path:
            os.makedirs(path, exist_ok=True)
            _build.BUILD_DIR = Path(path).resolve()
        return str(_build.BUILD_DIR)
    except OSError as exc:
        logging.getLogger(__name__).warning(
            "kernel build directory %r unusable (%s: %s); keeping %s",
            path, type(exc).__name__, exc, _build.BUILD_DIR)
        return str(_build.BUILD_DIR)
