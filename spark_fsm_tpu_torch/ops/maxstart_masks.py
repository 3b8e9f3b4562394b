"""Window masks of constrained-SPADE max-start states, for kernel B1.

A candidate's child state is ``occ[p] and base[p] >= 0 ? base[p] : -1``
(``base`` = the parent node's ``prev_max`` state ``pm`` for an
s-extension, its state ``m`` for an i-extension; ``ops/maxstart_torch``),
and its windowed support counts the sequences with some ``p`` where the
child starts and ``p - child[p] <= min(maxwindow, n_pos)``.  That is the
count of sequences where ``mask & occ`` has a bit, with

    mask[p] = base[p] >= 0 and p - base[p] <= min(maxwindow, n_pos)

(no window: ``base[p] >= 0``), a mask of the parent node alone.  So the
cSPADE engine writes two masks a node and lets B1
(``ops/pair_support``) count every (mask, item) pair, instead of building
a child state for every candidate.

:func:`window_masks` returns ``[2 nb, S * n_words]`` int32 words in B1's
flat layout: row ``2b`` is node b's mask from ``pm``, row ``2b + 1`` its
mask from ``m``; bit ``p % 32`` of word ``p // 32`` of a sequence is
position p.  Two versions of it live here:
- the CUDA kernel ``csrc/maxstart_masks.cu`` (built for sm_90a at first
  use, see ``_build.py``), launched for CUDA tensors — it launches or
  raises, never falls back;
- :func:`window_masks_plain`, plain tensor ops, taken for CPU tensors,
  which the tests hold the kernel against.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from spark_fsm_tpu_torch.ops import _build
from spark_fsm_tpu_torch.ops.bitops_torch import pack_seq_bits


def check_states(m: torch.Tensor, pm: torch.Tensor, n_words: int) -> None:
    """Raise unless ``m`` and ``pm`` are contiguous ``[nb, S, 32 n_words]``
    int8 or int16 states of one shape, dtype and device, and, on a CUDA
    device, 16-byte aligned (the kernel's loads are 16 bytes)."""
    for name, t in (("m", m), ("pm", pm)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
        if t.dtype not in (torch.int8, torch.int16):
            raise TypeError(f"{name} must be int8 or int16 states, got {t.dtype}")
        if t.dim() != 3:
            raise ValueError(f"{name} must be [nb, S, n_pos], got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device.type == "cuda" and t.data_ptr() % 16:
            raise ValueError(f"{name}'s data must be 16-byte aligned")
    if m.shape != pm.shape or m.dtype != pm.dtype or m.device != pm.device:
        raise ValueError(f"m {tuple(m.shape)} {m.dtype} on {m.device} but pm "
                         f"{tuple(pm.shape)} {pm.dtype} on {pm.device}")
    if n_words < 1 or m.shape[2] != 32 * n_words:
        raise ValueError(f"n_pos={m.shape[2]} is not 32 * n_words={n_words}")


def window_bound(maxwindow: Optional[int], n_pos: int) -> int:
    """The span a start may reach back: ``min(maxwindow, n_pos)``, and
    ``n_pos`` (which every start passes) without a window."""
    return n_pos if maxwindow is None else min(int(maxwindow), n_pos)


def window_masks_plain(m: torch.Tensor, pm: torch.Tensor,
                       maxwindow: Optional[int],
                       n_words: int) -> torch.Tensor:
    """The plain PyTorch version: ``[2 nb, S * n_words]`` int32 masks."""
    check_states(m, pm, n_words)
    nb, S, n_pos = m.shape
    win = window_bound(maxwindow, n_pos)
    x = torch.stack([pm, m], 1).to(torch.int32)          # [nb, 2, S, n_pos]
    pos = torch.arange(n_pos, dtype=torch.int32, device=m.device)
    ok = (x >= 0) & ((pos - x) <= win)
    return pack_seq_bits(ok).view(2 * nb, S * n_words)


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = _build.load("maxstart_masks")
    fn = lib.maxstart_masks_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def window_masks(m: torch.Tensor, pm: torch.Tensor,
                 maxwindow: Optional[int], n_words: int) -> torch.Tensor:
    """``[2 nb, S * n_words]`` int32 window masks of the node states ``m``
    and their ``prev_max`` states ``pm`` (module docstring).  CUDA
    tensors launch the kernel (and raise if it cannot be built or
    launched); CPU tensors take :func:`window_masks_plain`; any other
    device raises.  Each launch adds one to ``window_masks.launches``; an
    empty batch or sequence axis returns an empty result without one."""
    check_states(m, pm, n_words)
    dev = m.device
    if dev.type == "cpu":
        return window_masks_plain(m, pm, maxwindow, n_words)
    if dev.type != "cuda":
        raise ValueError(f"window_masks runs on cuda (kernel) or cpu "
                         f"(plain version), got {dev}")
    nb, S, n_pos = m.shape
    out = torch.empty(2 * nb, S * n_words, dtype=torch.int32, device=dev)
    if nb == 0 or S == 0:
        return out
    fn = _kernel()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(m.data_ptr(), pm.data_ptr(), out.data_ptr(), nb, S, n_words,
            window_bound(maxwindow, n_pos), m.element_size(), stream)
    if rc != 0:
        raise RuntimeError(f"maxstart_masks kernel launch failed: CUDA error {rc}")
    window_masks.launches += 1
    return out


window_masks.launches = 0
