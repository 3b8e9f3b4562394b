"""Fused extension count + threshold prune — port of
``spark_fsm_tpu/ops/pallas_extend.py``.

For parent rows ``pt`` (plain and s-ext-transformed rows interleaved) and
the first ``n_item_rows`` rows of ``items``:

- ``raw[p, i] = #{s : OR_w (pt[p, s*W + w] & items[i, s*W + w]) != 0}``;
- ``sup[p, i] = raw[p, i]`` where it is at least ``thr``, else exactly 0
  (``thr >= 1``, so 0 always means dead);
- ``mask[p, i // 32]`` has bit ``i % 32`` set iff lane ``i`` survived
  (LSB first; int32 words holding the reference's uint32 bits).

Two versions of the same function live here:
- the CUDA kernel ``csrc/extend_prune.cu`` (built for sm_90a at first use,
  see ``_build.py``), which :func:`extend_count_prune` launches for CUDA
  tensors — it launches the kernel or raises, never falls back.  Given
  ``n_live``, the number of leading item rows that can be nonzero, it
  reads and counts only those lanes;
- :func:`extend_count_prune_plain`, plain tensor ops, the counterpart of
  the reference's ``extend_count_prune_jnp``: it computes the direct count
  and the dEclat spelling ``support(parent row) - |diffset|``, selects per
  row by ``use_diff`` (the two are an exact identity), thresholds and
  packs.  :func:`extend_count_prune` takes it for CPU tensors; the tests
  and ``chip_smoke.py`` hold the kernel against it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from spark_fsm_tpu_torch.ops import _build
from spark_fsm_tpu_torch.ops import bitops_torch as B
from spark_fsm_tpu_torch.ops.pair_support import check_operands

# arrival counters the kernel may use: one per parent tile (W = 1) or per
# 16 x 64 output tile (W > 1), both at most P * ceil(NI / 64)
_ARRIVALS_ITEM_TILE = 64
# blocks to aim for per SM when the W > 1 path splits the sequence axis
_BLOCKS_PER_SM = 16
# the plain version's [p_chunk, NI, S, W] temporary stays near this size
_CHUNK_BYTES = 256 << 20


def _check_thr_ni(thr: int, n_item_rows: int) -> None:
    if int(thr) < 1:
        raise ValueError(f"thr={thr}: the threshold must be >= 1, since a "
                         "pruned lane reads 0")
    if n_item_rows % 32:
        raise ValueError(f"n_item_rows={n_item_rows} must be a multiple of 32 "
                         "(whole mask words); pad the item rows with zeros")


def extend_count_prune_plain(p3: torch.Tensor, items3: torch.Tensor, thr: int,
                             use_diff: torch.Tensor):
    """The plain PyTorch version on the engine layout: ``p3`` [P, S, W] and
    ``items3`` [NI, S, W] int32 bitmap words, ``use_diff`` [P] bool (rows
    counted as ``support(parent row) - |diffset|``).  Returns ``(sup [P,
    NI] int32, mask [P, ceil(NI/32)] int32)``.  Works through P in chunks
    so the [p_chunk, NI, S, W] temporary stays near ``_CHUNK_BYTES``."""
    if int(thr) < 1:
        raise ValueError(f"thr={thr}: the threshold must be >= 1")
    P, S, W = p3.shape
    NI = items3.shape[0]
    if items3.shape[1:] != (S, W):
        raise ValueError(f"items {tuple(items3.shape)} do not match parents "
                         f"{tuple(p3.shape)}")
    ud = use_diff.to(device=p3.device, dtype=torch.bool)
    sup = torch.empty(P, NI, dtype=torch.int32, device=p3.device)
    pc = max(1, _CHUNK_BYTES // max(1, NI * S * W * 4))
    for lo in range(0, P, pc):
        p = p3[lo:lo + pc]
        child_alive = B.contains_bits(p[:, None] & items3[None])  # [pc, NI, S]
        direct = B.alive_popcount(child_alive)
        parent_alive = B.contains_bits(p)                       # [pc, S]
        diff = B.support_from_diffset(
            B.alive_popcount(parent_alive)[:, None],
            B.diffset_count(parent_alive[:, None], child_alive))
        sup[lo:lo + pc] = torch.where(ud[lo:lo + pc, None], diff, direct)
    alive = sup >= int(thr)
    return torch.where(alive, sup, 0), B.pack_seq_bits(alive)


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = _build.load("extend_prune")
    fn = lib.extend_prune_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def extend_count_prune(pt: torch.Tensor, items: torch.Tensor, thr: int,
                       n_item_rows: int, n_words: int = 1,
                       n_live: int | None = None):
    """``(sup [P, n_item_rows] int32, mask [P, n_item_rows // 32] int32)``
    for flat ``[rows, S*W]`` operands.  ``n_live`` (default: all of them)
    is how many leading item rows can be nonzero: the caller vouches that
    rows ``n_live..n_item_rows-1`` are all zero, so their lanes are written
    dead without being read or counted, which is what counting them gives.
    CUDA tensors launch the kernel (and raise if it cannot be built or
    launched); CPU tensors take :func:`extend_count_prune_plain` over the
    live rows with every row counted directly; any other device raises.
    Each launch adds one to ``extend_count_prune.launches``."""
    check_operands(pt, items, n_item_rows, n_words)
    _check_thr_ni(thr, n_item_rows)
    n_live = n_item_rows if n_live is None else int(n_live)
    if not 0 <= n_live <= n_item_rows:
        raise ValueError(f"n_live={n_live} outside 0..n_item_rows="
                         f"{n_item_rows}")
    dev = pt.device
    P, SW = pt.shape
    S = SW // n_words
    if dev.type == "cpu":
        sup = torch.zeros(P, n_item_rows, dtype=torch.int32)
        if n_live:
            sup[:, :n_live] = extend_count_prune_plain(
                pt.view(P, S, n_words),
                items[:n_live].view(n_live, S, n_words), thr,
                torch.zeros(P, dtype=torch.bool))[0]
        return sup, B.pack_seq_bits(sup != 0)
    if dev.type != "cuda":
        raise ValueError(f"extend_count_prune runs on cuda (kernel) or cpu "
                         f"(plain version), got {dev}")
    # one zero-fill for the outputs and the arrival counters
    n_mask = n_item_rows // 32
    n_arr = P * -(-n_item_rows // _ARRIVALS_ITEM_TILE)
    buf = torch.zeros(P * (n_item_rows + n_mask) + n_arr, dtype=torch.int32,
                      device=dev)
    sup = buf[:P * n_item_rows].view(P, n_item_rows)
    mask = buf[P * n_item_rows:P * (n_item_rows + n_mask)].view(P, n_mask)
    if P == 0 or S == 0:
        return sup, mask
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rc = _kernel()(pt.data_ptr(), items.data_ptr(), sup.data_ptr(),
                   mask.data_ptr(), buf[P * (n_item_rows + n_mask):].data_ptr(),
                   P, n_item_rows, n_live, S, n_words, int(thr),
                   _BLOCKS_PER_SM * sms,
                   torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"extend_prune kernel launch failed: CUDA error {rc} (error 1, "
            f"invalid value, is also a W={n_words} whose staged rows need "
            f"more shared memory than a block may have)")
    extend_count_prune.launches += 1
    return sup, mask


extend_count_prune.launches = 0
