"""The native SequenceDB tokenizer — copy of
``spark_fsm_tpu/data/fasttok.py``.

``_fasttok.c`` is compiled with ``gcc`` against this interpreter's
``Python.h`` into ``build/host/`` at the repository root (beside the
CUDA kernels' ``build/kernels/``), at first use and never at import.
The library's name carries the interpreter tag and a hash of the source,
and the build is renamed into place atomically, so an edited source
always rebuilds and concurrent builds race safely.

When the extension cannot be built or loaded (no compiler, no
``Python.h``), :func:`flatten` returns None and the callers
(``vertical.build_vertical``, ``vertical.dataset_stats``) use
:func:`flatten_numpy`: the bytes are the same either way.
:func:`backend` says which one runs, and :func:`reason` why the native
one does not.  Left out of the copy: the reference's ``SPARKFSM_FASTTOK``
environment switch (tests call :func:`flatten_numpy` directly).
"""

from __future__ import annotations

import functools
import hashlib
import importlib.util
import os
import subprocess
import sys
import sysconfig
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SRC = Path(__file__).resolve().parent / "_fasttok.c"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "host"


def library_path() -> Path:
    tag = f"cp{sys.version_info.major}{sys.version_info.minor}"
    h = hashlib.sha256(SRC.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"_fasttok-{tag}-{h}.so"


def build() -> Path:
    """Compile ``_fasttok.c`` unless this source's library exists; returns
    its path.  Raises ``FileNotFoundError`` without ``Python.h`` or
    ``gcc``, and ``subprocess.CalledProcessError`` (with gcc's output)
    when the compile fails."""
    out = library_path()
    if out.exists():
        return out
    inc = Path(sysconfig.get_paths()["include"])
    if not (inc / "Python.h").exists():
        raise FileNotFoundError(f"no Python.h under {inc}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    subprocess.run(["gcc", "-O2", "-shared", "-fPIC", f"-I{inc}", str(SRC),
                    "-o", str(tmp)], check=True, capture_output=True,
                   text=True, timeout=120)
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def _load():
    """``(module, None)``, or ``(None, why)`` when it cannot be built or
    loaded; tried once per process."""
    try:
        so = build()
        spec = importlib.util.spec_from_file_location("_fasttok", so)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    except subprocess.CalledProcessError as exc:
        return None, f"gcc failed (rc {exc.returncode}): {exc.stderr.strip()}"
    except (OSError, ImportError, subprocess.SubprocessError) as exc:
        return None, f"{type(exc).__name__}: {exc}"
    return mod, None


def backend() -> str:
    """``"native"`` when the C tokenizer runs, else ``"numpy"``."""
    return "numpy" if _load()[0] is None else "native"


def reason() -> Optional[str]:
    """Why the native tokenizer does not run (None when it does)."""
    return _load()[1]


def flatten(db) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """(seq_lengths int32, itemset_counts int64, raw_items int64) for a
    SequenceDB through the C extension, or None when it is unavailable.
    Arrays are read-only views over the C buffers."""
    mod = _load()[0]
    if mod is None:
        return None
    lengths_b, counts_b, items_b = mod.flatten(db)
    return (np.frombuffer(lengths_b, np.int32),
            np.frombuffer(counts_b, np.int64),
            np.frombuffer(items_b, np.int64))


def flatten_numpy(db) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The numpy flatten: the semantics the C extension matches byte for
    byte, and the fallback when it cannot be built."""
    lengths = np.fromiter((len(s) for s in db), np.int32, count=len(db))
    counts = np.fromiter((len(iset) for s in db for iset in s), np.int64)
    items = np.fromiter((it for s in db for iset in s for it in iset),
                        np.int64)
    return lengths, counts, items


def tokenize(db) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """:func:`flatten`, or :func:`flatten_numpy` when it is unavailable."""
    ft = flatten(db)
    return flatten_numpy(db) if ft is None else ft
