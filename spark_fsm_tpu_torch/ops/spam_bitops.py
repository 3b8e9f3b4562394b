"""SPAM wave passes — port of ``spark_fsm_tpu/ops/spam_bitops.py``
(``wave_supports_fn``, ``wave_extend_prune_fn``, ``gather_rows_fn`` and
``pair_prune_fn``, each with and without a mesh).

SPAM evaluates a popped node against the whole item axis: one wave of
``Bn`` nodes is one pass of shape ``[2*Bn, nd_pad]``, however ragged the
nodes' candidate lists are.  The layouts are the classic engine's: flat
``[rows, S*W]`` int32 stores (word minor); ``pt`` interleaves plain and
transformed parent rows (row ``2b`` node b, row ``2b+1`` its s-ext
transform); padded sequences and item rows ``n_items..nd_pad-1`` are
all-zero, so a pad lane's support is exactly 0.

- :func:`wave_extend_prune` is the engine's wave: kernel B3
  (``ops/extend_prune.py``) on the card, its plain spelling on the CPU.
- :func:`wave_supports` is the unfused wave (pair supports only), a thin
  call of kernel B1; the engine does not use it.
- :func:`gather_rows` and :func:`pair_prune` are plain tensor code, as
  the reference's are jnp: the hybrid store's dense-block gather and its
  sparse (id-list) half.

Under a ``mesh`` (``parallel.mesh.SeqMesh``; the operands are this rank's
block of the sequence axis) every count is a partial one and is
all-reduced (SUM) before its threshold, as the reference ``psum``s before
its.  So the mesh wave is B1 on the shard, the all-reduce, then the
threshold and the pack as torch ops: B3's in-kernel prune is right only
where the kernel sees the whole sequence axis.  The dEclat spelling is an
exact identity per shard too (a shard's child alive-set is a subset of
its parent's), so it commutes with the reduce and the flags change no
byte.  The gather is per-sequence and stays local.
"""

from __future__ import annotations

import torch

from spark_fsm_tpu_torch.ops import bitops_torch as B
from spark_fsm_tpu_torch.ops import extend_prune as EP
from spark_fsm_tpu_torch.ops import pair_support as PS
from spark_fsm_tpu_torch.parallel.mesh import all_reduce_sum

# item axis tile of the wave: the item row count rounds up to it, and the
# engine's geometry sizes the node batch against a [2*Bn, ITEM_TILE, S, W]
# temporary (the plain spelling's)
ITEM_TILE = 64


def pad_items(n_items: int, tile: int = ITEM_TILE) -> int:
    """Item-axis pad: the item row count rounded up to a tile multiple."""
    return max(tile, -(-max(n_items, 1) // tile) * tile)


def wave_supports(pt: torch.Tensor, store: torch.Tensor, n_words: int,
                  ni_pad: int, mesh=None,
                  n_live: int | None = None) -> torch.Tensor:
    """``sup[2*Bn, ni_pad]``: the support of every interleaved parent row
    AND every item row; s-extensions read ``sup[2b+1, i]``, i-extensions
    ``sup[2b, i]``.  ``n_live`` (default ``ni_pad``) is the number of
    leading item rows that can be nonzero, as for :func:`wave_extend_prune`."""
    return all_reduce_sum(PS.pair_supports(pt, store, ni_pad, n_words, n_live),
                          mesh)


def wave_extend_prune(pt: torch.Tensor, items: torch.Tensor, thr: int,
                      use_diff: torch.Tensor, *, n_words: int, nd_pad: int,
                      n_live: int | None = None):
    """The fused wave: ``(sup [2*Bn, nd_pad] int32, mask [2*Bn, nd_pad/32]
    int32)`` for ``pt`` [2*Bn, S*W] and the first ``nd_pad`` rows of
    ``items`` (the store on the pure-bitmap plan, the gathered dense block
    on the hybrid plan).  ``sup`` is the exact count where it is at least
    ``thr`` and exactly 0 elsewhere; ``mask`` holds the survivor bits.

    ``n_live`` (default ``nd_pad``) is the number of leading item rows that
    can be nonzero: the engine's real items, whose pad rows after them are
    all zero.  On a CUDA tensor it launches kernel B3, which counts directly
    and only the live lanes; on the CPU it runs the plain spelling over all
    ``nd_pad`` rows, which counts the rows flagged in ``use_diff`` ([2*Bn]
    bool) as ``support(parent row) - |diffset|``.  The two spellings are an
    exact identity and a zero row's lane is dead either way, so neither the
    flag nor the hint changes the bytes.  A sharded wave takes
    :func:`wave_prune_sharded`."""
    if pt.device.type != "cpu":
        return EP.extend_count_prune(pt, items, thr, nd_pad, n_words,
                                     n_live=n_live)
    P = pt.shape[0]
    S = pt.shape[1] // n_words
    return EP.extend_count_prune_plain(
        pt.view(P, S, n_words), items[:nd_pad].view(nd_pad, S, n_words), thr,
        use_diff)


def wave_prune_sharded(pt: torch.Tensor, items: torch.Tensor, thr: int, *,
                       n_words: int, nd_pad: int, mesh,
                       n_live: int | None = None):
    """:func:`wave_extend_prune`'s ``(sup, mask)`` for this rank's block of
    the sequence axis (the reference's ``wave_extend_prune_fn(mesh)``):
    B1 (``pair_supports``: the kernel on CUDA, its plain version on the
    CPU) on the shard, the all-reduce, then the threshold and the pack.
    B3 never runs here: its in-kernel prune would threshold partial
    counts.  ``n_live`` is :func:`wave_extend_prune`'s."""
    sup = wave_supports(pt, items, n_words, nd_pad, mesh, n_live)
    alive = sup >= int(thr)
    return torch.where(alive, sup, 0), B.pack_seq_bits(alive)


def gather_rows(store: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """The hybrid store's dense block: ``store[rows]`` as a compact
    ``[len(rows), S*W]`` tensor, with ``-1`` rows all-zero.  Item rows never
    change after the store is built, so one gather serves a whole mine."""
    got = store.index_select(0, rows.clamp(min=0).long())
    return torch.where((rows >= 0)[:, None], got, 0)


def pair_prune(pt: torch.Tensor, store: torch.Tensor, pref: torch.Tensor,
               item: torch.Tensor, thr: int, use_diff: torch.Tensor,
               n_words: int, mesh=None) -> torch.Tensor:
    """The hybrid store's sparse half: ``sup[C]`` for explicit (parent row,
    item row) pairs — ``pref`` indexes ``pt``'s interleaved rows, ``item``
    the store's item rows with ``-1`` for pad lanes, ``use_diff`` picks the
    dEclat spelling per pair.  The exact count where it is at least
    ``thr``, exactly 0 elsewhere and on pad lanes."""
    C = item.shape[0]
    prows = pt.index_select(0, pref.long()).view(C, -1, n_words)
    irows = store.index_select(0, item.clamp(min=0).long()).view(C, -1, n_words)
    child_alive = B.contains_bits(prows & irows)       # [C, S]
    parent_alive = B.contains_bits(prows)
    direct = B.alive_popcount(child_alive)
    diff = B.support_from_diffset(B.alive_popcount(parent_alive),
                                  B.diffset_count(parent_alive, child_alive))
    sup = all_reduce_sum(torch.where(use_diff.bool(), diff, direct), mesh)
    return torch.where((item >= 0) & (sup >= int(thr)), sup, 0)
