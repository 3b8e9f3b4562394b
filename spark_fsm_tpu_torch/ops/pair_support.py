"""SPADE pair-support matrix — port of ``spark_fsm_tpu/ops/pallas_support.py``.

``out[p, i] = #{s : OR_w (pt[p, s*W + w] & items[i, s*W + w]) != 0}`` for the
parent rows ``pt`` (plain and s-ext-transformed rows interleaved) and the
first ``n_item_rows`` rows of ``items`` (the engine's bitmap store, whose
leading rows are the item id-lists).  Both operands are read in the
engine's native flat layout ``[rows, S*W]`` (word minor), int32 words
holding uint32 bits; no transpose is made.  ``n_live`` (default
``n_item_rows``) is the number of leading item rows that can be nonzero:
the engine's real items, whose pad rows after them are all zero.  Columns
from ``n_live`` on are 0 and cost no work, in the kernel and in the plain
version alike.

Two versions of the same function live here:
- the CUDA kernel ``csrc/pair_support.cu`` (built for sm_90a at first use,
  see ``_build.py``), which :func:`pair_supports` launches for CUDA
  tensors — it launches the kernel or raises, never falls back;
- :func:`pair_supports_plain`, plain tensor ops chunked over P, which
  :func:`pair_supports` uses for CPU tensors, and which the tests and
  ``chip_smoke.py`` hold the kernel against.

:func:`batch_supports` extracts ``out[pref, item]`` per candidate on the
device, so the host reads back 4 bytes per candidate.

Traced (``utils/obs``), each launch is one ``b1.launch`` span carrying its
geometry (``P``, ``NI``, ``n_live``, ``S``, ``W``) and ``point`` (``kernel``
or ``plain``): the program's own launch record.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from spark_fsm_tpu_torch.ops import _build
from spark_fsm_tpu_torch.utils import obs

# The engines pad their sequence axis to SEQ_TILE, so rows are 16-byte
# aligned and the kernel (csrc/pair_support.cu, which picks its own tiles
# and sequence splits) stages them with 16-byte copies; it masks any ragged
# P, NI and S itself.
SEQ_TILE = 32
# the plain version's [p_chunk, NI, S, W] temporary stays near this size
_CHUNK_BYTES = 256 << 20


def check_operands(pt: torch.Tensor, items: torch.Tensor, n_item_rows: int,
                   n_words: int) -> None:
    """Raise unless ``pt`` and ``items`` are contiguous flat ``[rows, S*W]``
    int32 tensors on one device whose first ``n_item_rows`` rows exist."""
    for name, t in (("pt", pt), ("items", items)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32 bitmap words, got {t.dtype}")
        if t.dim() != 2:
            raise ValueError(f"{name} must be flat [rows, S*W], got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if pt.device != items.device:
        raise ValueError(f"pt on {pt.device} but items on {items.device}")
    if n_words < 1 or pt.shape[1] % n_words:
        raise ValueError(f"row width {pt.shape[1]} is not a multiple of "
                         f"n_words={n_words}")
    if items.shape[1] != pt.shape[1]:
        raise ValueError(f"row widths differ: pt {pt.shape[1]}, items "
                         f"{items.shape[1]}")
    if not 0 < n_item_rows <= items.shape[0]:
        raise ValueError(f"n_item_rows={n_item_rows} outside 1..{items.shape[0]}")


def live_rows(n_item_rows: int, n_live) -> int:
    """``n_live`` checked against ``0..n_item_rows`` (None: all rows)."""
    if n_live is None:
        return n_item_rows
    if isinstance(n_live, bool) or not isinstance(n_live, int):
        raise TypeError(f"n_live must be an int, got {type(n_live)}")
    if not 0 <= n_live <= n_item_rows:
        raise ValueError(f"n_live={n_live} outside 0..{n_item_rows}")
    return n_live


def pair_supports_plain(pt: torch.Tensor, items: torch.Tensor,
                        n_item_rows: int, n_words: int = 1,
                        n_live: int | None = None) -> torch.Tensor:
    """The plain PyTorch version: [P, n_item_rows] int32 supports, computed
    over the first ``n_live`` item rows and zero after them.  Works through
    P in chunks so the [p_chunk, n_live, S, W] temporary stays near
    ``_CHUNK_BYTES``."""
    check_operands(pt, items, n_item_rows, n_words)
    n_live = live_rows(n_item_rows, n_live)
    P, SW = pt.shape
    S = SW // n_words
    out = torch.zeros(P, n_item_rows, dtype=torch.int32, device=pt.device)
    if n_live == 0:
        return out
    it = items[:n_live].reshape(1, n_live, S, n_words)
    pc = max(1, _CHUNK_BYTES // max(1, n_live * SW * 4))
    for lo in range(0, P, pc):
        a = pt[lo:lo + pc].reshape(-1, 1, S, n_words)
        hit = ((a & it) != 0).any(dim=-1)          # [pc, n_live, S]
        out[lo:lo + pc, :n_live] = hit.sum(dim=-1, dtype=torch.int32)
    return out


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = _build.load("pair_support")
    fn = lib.pair_support_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def pair_supports(pt: torch.Tensor, items: torch.Tensor, n_item_rows: int,
                  n_words: int = 1, n_live: int | None = None) -> torch.Tensor:
    """[P, n_item_rows] int32 pair supports, zero from column ``n_live`` on.
    CUDA tensors launch the kernel (and raise if it cannot be built or
    launched); CPU tensors take :func:`pair_supports_plain`; any other
    device raises.  Each launch adds one to ``pair_supports.launches``;
    ``n_live = 0`` (and an empty P or S) returns zeros without one."""
    check_operands(pt, items, n_item_rows, n_words)
    n_live = live_rows(n_item_rows, n_live)
    dev = pt.device
    P, SW = pt.shape
    S = SW // n_words
    geometry = dict(P=P, NI=n_item_rows, n_live=n_live, S=S, W=n_words)
    if dev.type == "cpu":
        with obs.span("b1.launch", point="plain", **geometry):
            return pair_supports_plain(pt, items, n_item_rows, n_words,
                                       n_live)
    if dev.type != "cuda":
        raise ValueError(f"pair_supports runs on cuda (kernel) or cpu "
                         f"(plain version), got {dev}")
    out = torch.zeros(P, n_item_rows, dtype=torch.int32, device=dev)
    if P == 0 or S == 0 or n_live == 0:
        return out
    fn = _kernel()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with obs.span("b1.launch", point="kernel", **geometry):
        rc = fn(pt.data_ptr(), items.data_ptr(), out.data_ptr(), P,
                n_item_rows, n_live, S, n_words, stream)
    if rc != 0:
        raise RuntimeError(f"pair_support kernel launch failed: CUDA error {rc}")
    pair_supports.launches += 1
    return out


pair_supports.launches = 0


def _extract(out: torch.Tensor, pref: torch.Tensor, item: torch.Tensor):
    if pref.device != out.device or item.device != out.device:
        raise ValueError("candidate indices must lie on the bitmaps' device")
    return out[pref.long(), item.long()]


def batch_supports(pt: torch.Tensor, items: torch.Tensor, n_item_rows: int,
                   pref: torch.Tensor, item: torch.Tensor,
                   n_words: int = 1, n_live: int | None = None) -> torch.Tensor:
    """Pair matrix + on-device candidate extraction: ``pref``/``item``
    index (parent-or-transform row, item row) per candidate; returns
    [n_candidates] int32 supports."""
    return _extract(pair_supports(pt, items, n_item_rows, n_words, n_live),
                    pref, item)


def batch_supports_plain(pt: torch.Tensor, items: torch.Tensor,
                         n_item_rows: int, pref: torch.Tensor,
                         item: torch.Tensor, n_words: int = 1,
                         n_live: int | None = None) -> torch.Tensor:
    """:func:`batch_supports` through the plain version on any device."""
    return _extract(pair_supports_plain(pt, items, n_item_rows, n_words,
                                        n_live), pref, item)
