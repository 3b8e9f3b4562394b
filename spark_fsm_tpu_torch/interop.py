"""State carried across the two packages.

This system has no weights: its state is the device bitmap store and the
DFS frontier snapshot.
- The store: the reference keeps a flat ``[rows, S*W]`` uint32 store; the
  port keeps the same bits as int32.  :func:`store_from_numpy` and
  :func:`store_to_numpy` convert between the reference's store (as a
  numpy array) and the port's tensor, bit for bit.
- TSR's prefix/suffix-OR rows: the reference keeps them as ``[m, S, W]``
  uint32 arrays; the port keeps flat ``[m+1, S*W]`` int32 stores with the
  all-ones pad row last.  :func:`tsr_prep_from_numpy` converts.
- The frontier snapshot is a JSON-able dict in the same format in both
  packages (``models/_common.encode_frontier`` for SPADE,
  ``models/tsr.TsrTorch.frontier_state`` for TSR), shared as is.  It is
  host data, so a snapshot taken by a mesh mine of either package resumes
  in the other's mesh mine of the same size, or on one device.
- A sharded store: :func:`shard_store_from_numpy` gives a mesh rank its
  block of a reference store's sequence axis, as the engines' sharded
  store builders lay it out.
- A partitioned mine's composite snapshot (``parallel/partition.
  composite_state``: the merged rows, the active partition's frontier in
  its engine's format, the plan's fingerprint) is host JSON too, shared
  as is.  A ``PartitionPlan`` is a pure function of the vertical DB's item
  ids and supports (the same splitmix64 class hash, the same LPT order),
  so both packages build the same plan from the same database and each
  resumes the other's composite.  The port nests the active frontier with
  all of its slice's results (``results_done=0``), so a composite taken
  mid-slice resumes in either package; the reference nests the engine's
  delta snapshot.
"""

from __future__ import annotations

import numpy as np
import torch

from spark_fsm_tpu_torch.device import DeviceLike, resolve_device
from spark_fsm_tpu_torch.parallel.mesh import shard_bounds


def store_from_numpy(arr: np.ndarray, device: DeviceLike = None) -> torch.Tensor:
    """Flat ``[rows, S*W]`` uint32 store -> int32 tensor with the same bits
    on ``device`` (default CUDA)."""
    arr = np.asarray(arr)
    if arr.dtype != np.uint32 or arr.ndim != 2:
        raise ValueError(f"expected a 2-D uint32 store, got {arr.dtype} "
                         f"{arr.shape}")
    # a writable contiguous copy only where needed (torch refuses to wrap
    # read-only numpy memory)
    words = np.require(arr, requirements=["C", "W"]).view(np.int32)
    return torch.from_numpy(words).to(resolve_device(device))


def shard_store_from_numpy(arr: np.ndarray, mesh, n_words: int = 1,
                           width: int = None) -> torch.Tensor:
    """The rank's block of a flat ``[rows, S*W]`` uint32 reference store
    (``S`` the global sequence axis, a multiple of the mesh size): the
    sequences of ``parallel.mesh.shard_bounds(S, mesh)`` as an int32
    tensor on the mesh's device, zero-padded to ``width`` sequences when
    given (the engines pad each block to B1's tile,
    ``models._common.shard_width``)."""
    arr = np.asarray(arr)
    if arr.dtype != np.uint32 or arr.ndim != 2 or arr.shape[1] % n_words:
        raise ValueError(f"expected a 2-D uint32 store of W={n_words} "
                         f"words a sequence, got {arr.dtype} {arr.shape}")
    lo, hi = shard_bounds(arr.shape[1] // n_words, mesh)
    block = arr[:, lo * n_words:hi * n_words]
    if width is not None and width > hi - lo:
        block = np.pad(block, ((0, 0), (0, (width - (hi - lo)) * n_words)))
    return store_from_numpy(np.ascontiguousarray(block), mesh.device)


def store_to_numpy(store: torch.Tensor) -> np.ndarray:
    """The port's int32 store -> the reference's uint32 numpy layout."""
    if store.dtype != torch.int32:
        raise ValueError(f"expected an int32 store, got {store.dtype}")
    return store.detach().cpu().contiguous().numpy().view(np.uint32)


def tsr_prep_from_numpy(p: np.ndarray, s: np.ndarray,
                        device: DeviceLike = None):
    """The reference's TSR preps (``[m, S, W]`` uint32 prefix- and
    suffix-OR rows) -> the port's ``(p1, s1)``: flat ``[m+1, S*W]`` int32
    tensors on ``device`` (default CUDA) with the all-ones pad row
    appended."""
    out = []
    for arr in (p, s):
        arr = np.asarray(arr)
        if arr.dtype != np.uint32 or arr.ndim != 3:
            raise ValueError(f"expected [m, S, W] uint32 rows, got "
                             f"{arr.dtype} {arr.shape}")
        pad = np.full((1, arr.shape[1] * arr.shape[2]), 0xFFFFFFFF, np.uint32)
        out.append(store_from_numpy(
            np.concatenate([arr.reshape(arr.shape[0], -1), pad]), device))
    return out[0], out[1]
