"""SPADE pair-support matrix — port of ``spark_fsm_tpu/ops/pallas_support.py``.

``out[p, i] = #{s : OR_w (pt[p, s*W + w] & items[i, s*W + w]) != 0}`` for the
parent rows ``pt`` (plain and s-ext-transformed rows interleaved) and the
first ``n_item_rows`` rows of ``items`` (the engine's bitmap store, whose
leading rows are the item id-lists).  Both operands are read in the
engine's native flat layout ``[rows, S*W]`` (word minor), int32 words
holding uint32 bits; no transpose is made.

Two versions of the same function live here:
- the CUDA kernel ``csrc/pair_support.cu`` (built for sm_90a at first use,
  see ``_build.py``), which :func:`pair_supports` launches for CUDA
  tensors — it launches the kernel or raises, never falls back;
- :func:`pair_supports_plain`, plain tensor ops chunked over P, which
  :func:`pair_supports` uses for CPU tensors, and which the tests and
  ``chip_smoke.py`` hold the kernel against.

:func:`batch_supports` extracts ``out[pref, item]`` per candidate on the
device, so the host reads back 4 bytes per candidate.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from spark_fsm_tpu_torch.ops import _build

# The kernel's tiles (csrc/pair_support.cu): 64 x 64 output tiles, sequences
# staged in chunks of at most 32 words.  The engine pads its sequence axis
# to SEQ_TILE so every single-word stage is full; the kernel itself masks
# any ragged P, NI and S.
ROW_TILE = 64
ITEM_TILE = 64
SEQ_TILE = 32
# blocks to aim for per SM when the sequence axis is split over gridDim.z
_BLOCKS_PER_SM = 16
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


def pair_supports_plain(pt: torch.Tensor, items: torch.Tensor,
                        n_item_rows: int, n_words: int = 1) -> torch.Tensor:
    """The plain PyTorch version: [P, n_item_rows] int32 supports.  Works
    through P in chunks so the [p_chunk, NI, S, W] temporary stays near
    ``_CHUNK_BYTES``."""
    check_operands(pt, items, n_item_rows, n_words)
    P, SW = pt.shape
    S = SW // n_words
    it = items[:n_item_rows].reshape(1, n_item_rows, S, n_words)
    out = torch.empty(P, n_item_rows, dtype=torch.int32, device=pt.device)
    pc = max(1, _CHUNK_BYTES // max(1, n_item_rows * SW * 4))
    for lo in range(0, P, pc):
        a = pt[lo:lo + pc].reshape(-1, 1, S, n_words)
        hit = ((a & it) != 0).any(dim=-1)          # [pc, NI, S]
        out[lo:lo + pc] = hit.sum(dim=-1, dtype=torch.int32)
    return out


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = _build.load("pair_support")
    fn = lib.pair_support_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _n_splits(device: torch.device, P: int, NI: int, S: int) -> int:
    """Sequence-axis splits (gridDim.z) so the grid holds about
    _BLOCKS_PER_SM blocks per SM, with at least one stage per split."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    tiles = (-(-P // ROW_TILE)) * (-(-NI // ITEM_TILE))
    want = -(-(_BLOCKS_PER_SM * sms) // tiles)
    return max(1, min(want, -(-S // SEQ_TILE), 65535))


def pair_supports(pt: torch.Tensor, items: torch.Tensor, n_item_rows: int,
                  n_words: int = 1) -> torch.Tensor:
    """[P, n_item_rows] int32 pair supports.  CUDA tensors launch the
    kernel (and raise if it cannot be built or launched); CPU tensors take
    :func:`pair_supports_plain`; any other device raises.  Each launch
    adds one to ``pair_supports.launches``."""
    check_operands(pt, items, n_item_rows, n_words)
    dev = pt.device
    if dev.type == "cpu":
        return pair_supports_plain(pt, items, n_item_rows, n_words)
    if dev.type != "cuda":
        raise ValueError(f"pair_supports runs on cuda (kernel) or cpu "
                         f"(plain version), got {dev}")
    P, SW = pt.shape
    S = SW // n_words
    out = torch.zeros(P, n_item_rows, dtype=torch.int32, device=dev)
    if P == 0 or S == 0:
        return out
    fn = _kernel()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(pt.data_ptr(), items.data_ptr(), out.data_ptr(), P, n_item_rows,
            S, n_words, _n_splits(dev, P, n_item_rows, S), stream)
    if rc != 0:
        raise RuntimeError(
            f"pair_support kernel launch failed: CUDA error {rc} (error 1, "
            f"invalid value, is also a W={n_words} whose staged rows need "
            f"more shared memory than a block may have)")
    pair_supports.launches += 1
    return out


pair_supports.launches = 0


def _extract(out: torch.Tensor, pref: torch.Tensor, item: torch.Tensor):
    if pref.device != out.device or item.device != out.device:
        raise ValueError("candidate indices must lie on the bitmaps' device")
    return out[pref.long(), item.long()]


def batch_supports(pt: torch.Tensor, items: torch.Tensor, n_item_rows: int,
                   pref: torch.Tensor, item: torch.Tensor,
                   n_words: int = 1) -> torch.Tensor:
    """Pair matrix + on-device candidate extraction: ``pref``/``item``
    index (parent-or-transform row, item row) per candidate; returns
    [n_candidates] int32 supports."""
    return _extract(pair_supports(pt, items, n_item_rows, n_words), pref, item)


def batch_supports_plain(pt: torch.Tensor, items: torch.Tensor,
                         n_item_rows: int, pref: torch.Tensor,
                         item: torch.Tensor, n_words: int = 1) -> torch.Tensor:
    """:func:`batch_supports` through the plain version on any device."""
    return _extract(pair_supports_plain(pt, items, n_item_rows, n_words),
                    pref, item)
