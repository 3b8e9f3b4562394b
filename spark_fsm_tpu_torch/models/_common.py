"""Shared host-side machinery for the batched-DFS engines — port of
``spark_fsm_tpu/models/_common.py``.

A device-resident bitmap store addressed by slot, a host DFS stack,
recompute-on-miss, and reclaim-from-stack-bottom when the pool runs dry.
The device steps both batched-DFS engines (SPADE's classic engine and
SPAM) share — a batch's parent-row prep, the materialize of surviving
children and the recompute of evicted bitmaps — live here as functions
on the store (the reference's ``spade_tpu._spade_fns``).  The whole-mine
engines (``spade_queue.py``, ``spade_fused.py``) add the reference's tile
constants where they decide routing and caps, a sync-free fixed-size
``nonzero`` and a scatter that drops masked rows into a trash row.
``FrontierNode``, ``encode_frontier``, ``decode_frontier`` and
``load_checkpoint`` are byte-for-byte copies of the reference's, so a
frontier snapshot taken by either package resumes in the other.

The mesh half (a ``parallel.mesh.SeqMesh``): :func:`device_axes` sizes
the GLOBAL sequence axis exactly as the reference sizes it for the same
number of shards, so every cap, route and counter derived from it
matches; each rank then keeps only its block of that axis
(:func:`shard_bounds`), padded inside the rank to B1's sequence tile
(:func:`shard_width`), and the store builders scatter only the tokens of
that block.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from spark_fsm_tpu_torch.ops import bitops_torch as B
from spark_fsm_tpu_torch.ops import pair_support as PS
from spark_fsm_tpu_torch.ops.ragged_batch import next_pow2
from spark_fsm_tpu_torch.device import resolve_device
from spark_fsm_tpu_torch.utils import obs
from spark_fsm_tpu_torch.parallel.mesh import (  # noqa: F401 (re-export)
    mesh_size, pad_to_multiple, rank0_decides, shard_bounds)


@dataclasses.dataclass
class FrontierNode:
    """DFS frontier node — the ONE shape `encode_frontier` serializes.
    Shared by every SPADE engine (classic, constrained, queue) so their
    snapshots interchange byte-for-byte: ``steps`` is the extension path
    in dense item indices, ``slot`` the device bitmap slot (None =
    rebuild on demand), ``s_list``/``i_list`` the surviving s-/i-
    extension candidate items."""

    steps: Tuple[Tuple[int, bool], ...]
    slot: object
    s_list: list
    i_list: list


def frontier_fingerprint(vdb, minsup: int, max_itemsets) -> dict:
    """Identity of the (vdb, minsup) a frontier snapshot binds to: the
    reference engines' exact fields, shared by the port's classic, queue
    and SPAM engines, so their snapshots interchange."""
    ids = vdb.item_ids
    return {
        "minsup": int(minsup),
        "n_items": int(vdb.n_items),
        "n_sequences": vdb.n_sequences,
        "max_itemsets": max_itemsets,  # changes enumeration
        "item_ids_head": [int(i) for i in ids[:8]],
        "item_ids_sum": int(ids.astype(np.int64).sum()),
    }


def encode_frontier(fingerprint: dict, stack, results,
                    results_from: int = 0) -> dict:
    """JSON-able DFS snapshot shared by both SPADE engines (and persisted
    verbatim by the service's StoreCheckpoint): unexplored nodes by their
    extension paths — device state is rebuilt by each engine's
    recompute-on-miss machinery on resume — plus the results emitted since
    ``results_from`` (results are append-only during a mine, so periodic
    checkpoints serialize only the delta)."""
    return {
        "version": 1,
        "fingerprint": fingerprint,
        "stack": [{"steps": [[int(i), int(s)] for i, s in n.steps],
                   "s": [int(x) for x in n.s_list],
                   "i": [int(x) for x in n.i_list]} for n in stack],
        "results_done": int(results_from),
        "results": [[[list(map(int, s)) for s in pat], int(sup)]
                    for pat, sup in results[results_from:]],
    }


def decode_frontier(resume: dict, fingerprint: dict, node_cls):
    """Inverse of encode_frontier; refuses a snapshot whose fingerprint
    does not match this engine's (node steps hold dense item indices that
    are only meaningful for the exact same projection + parameters)."""
    fp = resume.get("fingerprint")
    if fp != fingerprint:
        raise ValueError(
            "frontier checkpoint does not match this engine's (vdb, "
            f"parameters); checkpointed {fp}, engine {fingerprint}")
    results = [
        (tuple(tuple(int(i) for i in s) for s in pat), int(sup))
        for pat, sup in resume["results"]]
    nodes = [
        node_cls(tuple((int(i), bool(s)) for i, s in n["steps"]),
                 None,  # state rebuilt on demand (recompute-on-miss)
                 [int(x) for x in n["s"]], [int(x) for x in n["i"]])
        for n in resume["stack"]]
    return results, nodes


def load_checkpoint(checkpoint, fingerprint: dict):
    """Wrapper-side plumbing: ``(resume, save_cb, every_s)`` from an
    optional checkpoint object; a stale/mismatched snapshot is ignored
    (the mine restarts fresh) rather than refused."""
    if checkpoint is None:
        return None, None, 30.0
    resume = checkpoint.load()
    if resume is not None and resume.get("fingerprint") != fingerprint:
        resume = None
    return resume, checkpoint.save, getattr(checkpoint, "every_s", 30.0)


def scatter_build_store(vdb, n_rows: int, n_seq: int, n_words: int,
                        device: torch.device, mesh=None) -> torch.Tensor:
    """Scatter-build the flat ``[n_rows, n_seq * n_words]`` int32 bitmap
    store (word minor) on ``device`` from the vertical DB's token table;
    the dense store never exists on the host.  Item rows land in slots
    ``tok_item``; the other rows start zeroed.  With a ``mesh`` (``n_seq``
    the global axis, padded to the mesh size) the rank builds only its
    block: ``[n_rows, shard_width(n_seq, mesh) * n_words]`` from the
    tokens whose sequence lies in :func:`shard_bounds` (the reference's
    ``_store_builder`` shard scatter)."""
    with obs.span("store.build", rows=n_rows, tokens=len(vdb.tok_item)):
        toks = (vdb.tok_item, vdb.tok_seq, vdb.tok_word, vdb.tok_mask)
        if mesh is not None:
            toks = shard_tokens(*toks, n_seq, mesh)
            n_seq = shard_width(n_seq, mesh)
        return scatter_tokens(*toks, n_rows, n_seq, n_words, device)


def shard_tokens(ti: np.ndarray, ts: np.ndarray, tw: np.ndarray,
                 tm: np.ndarray, n_seq: int, mesh):
    """The tokens of the rank's block of a ``n_seq``-long sequence axis,
    their sequence ids made local to the block."""
    lo, hi = shard_bounds(n_seq, mesh)
    keep = (ts >= lo) & (ts < hi)
    return ti[keep], ts[keep] - lo, tw[keep], tm[keep]


def shard_width(n_seq: int, mesh, tile: int = PS.SEQ_TILE) -> int:
    """Width of the rank's local sequence axis: its block of the global
    axis padded to ``tile`` (B1's sequence tile; pad sequences are
    all-zero and count nothing).  ``n_seq`` itself without a mesh."""
    if mesh is None:
        return int(n_seq)
    lo, hi = shard_bounds(n_seq, mesh)
    return pad_to_multiple(hi - lo, tile)


def scatter_tokens(ti: np.ndarray, ts: np.ndarray, tw: np.ndarray,
                   tm: np.ndarray, n_rows: int, n_seq: int, n_words: int,
                   device: torch.device) -> torch.Tensor:
    """Scatter a token table (row, sequence, word, bit mask) into a zeroed
    flat ``[n_rows, n_seq * n_words]`` int32 store on ``device``.  The
    tokens are distinct bits, so the int32 accumulate is an OR — and it
    wraps through bit 31 exactly as the reference's uint32 ``.at[].add``
    does."""
    if len(ti) and (int(ti.max()) >= n_rows or int(ts.max()) >= n_seq):
        raise ValueError("token table reaches past the store's rows/sequences")
    flat = torch.zeros(n_rows * n_seq * n_words, dtype=torch.int32,
                       device=device)
    idx = (ti.astype(np.int64) * n_seq + ts) * n_words + tw
    mask = np.ascontiguousarray(tm, dtype=np.uint32).view(np.int32)
    flat.index_put_((torch.from_numpy(idx).to(device),),
                    torch.from_numpy(mask).to(device), accumulate=True)
    return flat.view(n_rows, n_seq * n_words)


def scatter_tokens_remap(ti: torch.Tensor, ts: torch.Tensor, tw: torch.Tensor,
                         tm: torch.Tensor, remap: torch.Tensor, n_rows: int,
                         n_seq: int, n_words: int) -> torch.Tensor:
    """The remap form of the token scatter, for tokens already on the
    device (the reference's ``_store_builder(flat=True, remap=True)``):
    token k lands in store row ``remap[ti[k]]``.  The reference drops a
    token whose row is out of range (``mode="drop"``: unneeded items and
    the remap's pad entries point past the store).  Here an out-of-range
    index would be a device assert that ends the CUDA context, and a
    boolean filter would read the count back to the host, so such a
    token's mask is zeroed and its row clamped: an add of 0 is a no-op.
    ``ti`` and ``remap`` are int64, ``tm`` int32 bit masks."""
    row = remap[ti]
    ok = row < n_rows
    row = torch.clamp(row, max=n_rows - 1)
    mask = torch.where(ok, tm, torch.zeros_like(tm))
    flat = torch.zeros(n_rows * n_seq * n_words, dtype=torch.int32,
                       device=ti.device)
    flat.index_add_(0, (row * n_seq + ts) * n_words + tw, mask)
    return flat.view(n_rows, n_seq * n_words)


# The reference's pair-kernel tiles (spark_fsm_tpu/ops/pallas_support.py),
# kept where they decide routing, caps and wave counts so those decisions
# and the engines' counters match the reference's: P_TILE rounds the
# whole-mine engines' wave and frontier widths, I_TILE pads their item axis
# (ni_pad) and sets the 1024-item alphabet bound.  B1 has its own tiles.
P_TILE = 16
I_TILE = 128


def nonzero_static(mask: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    """``jnp.nonzero(mask, size=size, fill_value=fill)`` for a 1-D bool
    tensor without a host sync (``torch.nonzero`` and boolean indexing
    read the count back): the indices of the first ``size`` set entries in
    order, then ``fill``.  Each set entry's rank (a cumsum) is its output
    slot; the rest scatter into one trash slot past the end."""
    rank = torch.cumsum(mask, 0) - 1
    dest = torch.where(mask & (rank < size), rank, size)
    out = torch.full((size + 1,), fill, dtype=torch.int64, device=mask.device)
    out.scatter_(0, dest, torch.arange(mask.shape[0], device=mask.device))
    return out[:size]


def copy_rows_drop(dst: torch.Tensor, idx: torch.Tensor, keep: torch.Tensor,
                   src: torch.Tensor) -> None:
    """``dst[idx[k]] = src[k]`` where ``keep[k]``, in place — the
    reference's ``.at[idx].set(src, mode="drop")``.  An out-of-range index
    in a torch index op is a device-side assert that ends the CUDA
    context, so ``dst``'s last row is a trash row that takes every dropped
    write; callers size each buffer one row past its live range and never
    read that row."""
    dst.index_copy_(0, torch.where(keep, idx, dst.shape[0] - 1), src)


def bucket_seq(n_seq: int) -> int:
    """The ``shape_buckets`` sequence-axis bucket shared by every engine:
    a power of two with a 128 floor (the reference's one definition, so
    streaming windows that mix engines land on one geometry)."""
    return max(128, next_pow2(n_seq))


def pad_tokens_pow2(ti, ts, tw, tm):
    """Pad the four parallel token arrays to a power-of-two length.  Pad
    tokens carry mask 0, so scattering them adds 0 to row 0: a no-op.
    The reference pads so that XLA compiles one scatter per bucket; TSR's
    bucketed round prep pads as it does."""
    cap = next_pow2(max(1, len(ti)))
    pad = cap - len(ti)
    if pad:
        z = ((0, pad),)
        ti, ts, tw, tm = (np.pad(a, z) for a in (ti, ts, tw, tm))
    return ti, ts, tw, tm


def device_axes(n_sequences: int, shape_buckets: bool = False,
                mesh=None) -> int:
    """The store's sequence axis: ``n_sequences`` (its
    :func:`bucket_seq` bucket when ``shape_buckets``) padded to the pair
    kernel's sequence tile.  Padded sequences are all-zero bitmaps and
    count nothing; the kernel masks ragged item and parent rows itself.

    With a ``mesh`` of N ranks it is the reference's global axis for N
    shards (``_common.device_axes(mesh=make_mesh(N))`` with its XLA path;
    B1 needs no Pallas sequence block): padded to a multiple of N.  Each
    rank pads its own block to the tile (:func:`shard_width`)."""
    n = bucket_seq(n_sequences) if shape_buckets else int(n_sequences)
    if mesh is not None:
        return pad_to_multiple(n, mesh_size(mesh))
    return -(-n // PS.SEQ_TILE) * PS.SEQ_TILE


def key_seq(n_sequences: int, shape_buckets: bool = False,
            mesh=None) -> int:
    """The sequence axis a shape key spells (``utils/shapes.py``): the
    reference's XLA-path axis, i.e. :func:`device_axes` before the pad to
    B1's sequence tile, so the port's keys equal the reference's for the
    same input and options."""
    n = bucket_seq(n_sequences) if shape_buckets else int(n_sequences)
    return pad_to_multiple(n, mesh_size(mesh)) if mesh is not None else n


def bucket_store_rows(total: int, n_fixed: int, budget_slots: int,
                      node_batch: int, depth: int) -> Tuple[int, int, int]:
    """The reference's ``shape_buckets`` store rounding
    (``spade_tpu.classic_geometry``, ``spam_bitmap.spam_geometry``):
    ``total`` = ``n_fixed`` fixed rows + pool + one scratch row is rounded
    up to a power of two, or down when rounding up overshoots the pool
    budget and the half still holds the fixed rows and a minimal pool of
    8.  The spare rows go to the pool and ``node_batch`` is clamped again
    so in-flight batches cannot starve a recompute.  Returns ``(total,
    pool_slots, node_batch)``."""
    floor_rows = n_fixed + 8 + 1
    total = next_pow2(total)
    if total > n_fixed + 1 + budget_slots and total // 2 >= floor_rows:
        total //= 2
    pool_slots = total - n_fixed - 1
    nb = max(1, min(node_batch, pool_slots // (3 * (depth + 2))))
    return total, pool_slots, nb


def launch_width_cap(pool_bytes: int, slot_bytes: int, floor: int) -> int:
    """Memory-safety ceiling on per-launch candidate widths: a
    join/materialize launch builds a ``[width, slot]`` tensor, so the width
    caps at the slots-worth that fits ~1/8 of the pool budget, floored to
    a power of two; ``floor`` guards against degenerate zero widths."""
    return max(int(floor), next_pow2(
        (int(pool_bytes) // 8) // max(int(slot_bytes), 1) + 1) // 2)


def engine_device(device, mesh) -> torch.device:
    """An engine's device: the caller's (:func:`resolve_device`), or the
    mesh rank's own when a ``mesh`` is given (a different explicit
    ``device`` is refused)."""
    if mesh is None:
        return resolve_device(device)
    if device is not None and resolve_device(device) != mesh.device:
        raise ValueError(f"device {device} differs from the mesh rank's "
                         f"device {mesh.device}")
    return mesh.device


def checkpoint_due(checkpoint_cb, last_ckpt: float, every_s: float,
                   mesh) -> bool:
    """The host loops' time-based checkpoint trigger.  Under a mesh it is
    rank 0's clock that decides, for every rank: the drain before a
    snapshot runs collectives, so all ranks must take the same branch."""
    if checkpoint_cb is None:
        return False
    return rank0_decides(time.monotonic() - last_ckpt >= every_s, mesh)


def device_hbm_budget(device: torch.device) -> int:
    """Usable device memory for engine working sets: 95% of the card's
    memory (``torch.cuda.mem_get_info``), or 4 GiB on the CPU."""
    if device.type == "cuda":
        _, total = torch.cuda.mem_get_info(device)
        return int(total * 0.95)
    return 4 << 30


def auto_pool_bytes(device: torch.device) -> int:
    """Default engine pool budget: 35% of the device memory budget, so
    two engine working sets plus kernel temporaries can coexist."""
    return int(device_hbm_budget(device) * 0.35)


def to_index(a, device: torch.device) -> torch.Tensor:
    """Host indices -> an int64 tensor on ``device``.  On CUDA the copy
    goes through pinned memory without blocking the host (a pageable
    upload waits for the stream)."""
    return to_device(np.asarray(a, dtype=np.int64), device)


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array -> a tensor on ``device``; on CUDA through pinned
    memory, without a host sync (the caching host allocator keeps the
    pinned buffer until the copy has run)."""
    t = torch.as_tensor(a)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def to_host(tensors):
    """Start the copy of each device tensor (None stays None) into a pinned
    host tensor and record one event behind them; CPU tensors stay as they
    are.  Returns ``(host_tensors, event_or_None)``."""
    live = [t for t in tensors if t is not None]
    if not live or live[0].device.type != "cuda":
        return list(tensors), None
    out = []
    for t in tensors:
        if t is None:
            out.append(None)
            continue
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        out.append(host)
    ev = torch.cuda.Event()
    ev.record()
    return out, ev


class CounterReader:
    """The host's read of a whole-mine engine's small int64 counter
    tensor after each wave or level — the reference's ``while_loop``
    condition.  One pinned buffer and one event are reused; the seconds
    the host spends waiting on the device are summed in ``wait_s``."""

    def __init__(self, n: int, device: torch.device):
        self.cuda = device.type == "cuda"
        self.host = torch.empty(n, dtype=torch.int64, pin_memory=self.cuda)
        self.event = torch.cuda.Event() if self.cuda else None
        self.wait_s = 0.0

    def read(self, ctr: torch.Tensor) -> List[int]:
        t0 = time.perf_counter()
        self.host.copy_(ctr, non_blocking=self.cuda)
        if self.cuda:
            self.event.record()
            self.event.synchronize()
        self.wait_s += time.perf_counter() - t0
        return self.host.tolist()


def prep_rows(store: torch.Tensor, slots, n_seq: int,
              n_words: int) -> torch.Tensor:
    """Gather the bitmaps at ``slots`` (host ints, or an index tensor on
    the store's device) and interleave each with its s-ext transform, once
    per batch: row ``2*b`` of the returned ``[2*len(slots), S*W]`` tensor
    is slot b's bitmap, row ``2*b+1`` its transform.  The rows are copies,
    so later in-place writes to the store's pool slots cannot reach a
    batch in flight."""
    if not isinstance(slots, torch.Tensor):
        slots = to_index(slots, store.device)
    parents = store.index_select(0, slots).view(len(slots), n_seq, n_words)
    pt = torch.stack([parents, B.sext_transform(parents)], dim=1)
    return pt.view(2 * len(slots), -1)


def materialize_rows(store: torch.Tensor, pt: torch.Tensor, ref: np.ndarray,
                     item: np.ndarray, iss: np.ndarray, out_slot: np.ndarray,
                     chunk: int) -> int:
    """``store[out_slot[k]] = pt[2*ref[k] + iss[k]] & store[item[k]]`` in
    place (the reference donated the store to a functional update
    instead), ``chunk`` children a launch; returns the launches."""
    dev = store.device
    launches = 0
    for lo in range(0, len(ref), chunk):
        hi = lo + chunk
        rows = (pt.index_select(0, to_index(2 * ref[lo:hi] + iss[lo:hi], dev))
                & store.index_select(0, to_index(item[lo:hi], dev)))
        store.index_copy_(0, to_index(out_slot[lo:hi], dev), rows)
        launches += 1
    return launches


def fold_rows(store: torch.Tensor, items: np.ndarray, iss: np.ndarray,
              valid: np.ndarray, n_seq: int, n_words: int) -> torch.Tensor:
    """Fold the joins along K steps (``[K, M]`` arrays, one column per
    node; a column's invalid steps leave its carry as it is) from the item
    rows: the ``[M, n_seq, n_words]`` bitmaps, bit-exact with the ones a
    mine builds step by step."""
    dev = store.device
    it = to_index(items, dev)
    ss = to_device(np.asarray(iss, bool), dev)
    vv = to_device(np.asarray(valid, bool), dev)
    bmp = store.index_select(0, it[0]).view(-1, n_seq, n_words)
    for k in range(1, it.shape[0]):
        nb = B.join(bmp, store.index_select(0, it[k]).view(-1, n_seq, n_words),
                    ss[k])
        bmp = torch.where(vv[k][:, None, None], nb, bmp)
    return bmp


def recompute_rows(store: torch.Tensor, items: np.ndarray, iss: np.ndarray,
                   valid: np.ndarray, slots: List[int], n_seq: int,
                   n_words: int) -> None:
    """Rebuild bitmaps with :func:`fold_rows` and write them to
    ``slots``."""
    bmp = fold_rows(store, items, iss, valid, n_seq, n_words)
    store.index_copy_(0, to_index(slots, store.device),
                      bmp.reshape(len(slots), -1))


def ensure_slots(store: torch.Tensor, pool: "SlotPool", batch, stack, *,
                 first_pool_slot: int, group: int, n_seq: int, n_words: int,
                 stats: dict) -> None:
    """Recompute the bitmaps of popped nodes that lost (or never had) a
    slot, ``group`` nodes a launch, reclaiming slots from the bottom of the
    stack when the pool is short.  Counts ``recomputed_nodes``,
    ``reclaimed_slots`` and ``kernel_launches`` in ``stats``."""
    missing = [n for n in batch if n.slot is None]
    if not missing:
        return
    stats["recomputed_nodes"] += len(missing)
    if len(pool) < len(missing):
        pool.reclaim(stack, len(missing), lambda n: n.slot >= first_pool_slot)
        stats["reclaimed_slots"] = pool.reclaimed
    for lo in range(0, len(missing), group):
        nodes = missing[lo: lo + group]
        k = max(len(n.steps) for n in nodes)
        items = np.zeros((k, len(nodes)), np.int64)
        iss = np.zeros((k, len(nodes)), bool)
        valid = np.zeros((k, len(nodes)), bool)
        slots = []
        for col, node in enumerate(nodes):
            slot = pool.alloc()
            if slot is None:
                raise RuntimeError("slot pool exhausted beyond reclaim")
            node.slot = slot
            slots.append(slot)
            for row, (it, s) in enumerate(node.steps):
                items[row, col], iss[row, col], valid[row, col] = it, s, True
        recompute_rows(store, items, iss, valid, slots, n_seq, n_words)
        stats["kernel_launches"] += 1


class SlotPool:
    """Free-list allocator over pool slot ids with stack reclaim.

    ``reclaim`` walks nodes bottom-of-stack-first (processed last, cheapest
    to recompute later), dropping their slots until ``need`` are free; the
    caller supplies which nodes are reclaimable (e.g. non-root).
    """

    def __init__(self, slots: range):
        self._free: List[int] = list(reversed(slots))
        self.reclaimed = 0

    def __len__(self) -> int:
        return len(self._free)

    def alloc(self) -> Optional[int]:
        return self._free.pop() if self._free else None

    def free(self, slot: int) -> None:
        self._free.append(slot)

    def reclaim(self, stack, need: int, reclaimable: Callable) -> None:
        for node in stack:
            if len(self._free) >= need:
                return
            if node.slot is not None and reclaimable(node):
                self._free.append(node.slot)
                node.slot = None
                self.reclaimed += 1
