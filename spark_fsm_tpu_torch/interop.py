"""State carried across the two packages.

This system has no weights: its state is the device bitmap store and the
DFS frontier snapshot.
- The store: the reference keeps a flat ``[rows, S*W]`` uint32 store; the
  port keeps the same bits as int32.  :func:`store_from_numpy` and
  :func:`store_to_numpy` convert between the reference's store (as a
  numpy array) and the port's tensor, bit for bit.
- The frontier snapshot is a JSON-able dict in the same format in both
  packages (``models/_common.encode_frontier``), shared as is.
"""

from __future__ import annotations

import numpy as np
import torch

from spark_fsm_tpu_torch.device import DeviceLike, resolve_device


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


def store_to_numpy(store: torch.Tensor) -> np.ndarray:
    """The port's int32 store -> the reference's uint32 numpy layout."""
    if store.dtype != torch.int32:
        raise ValueError(f"expected an int32 store, got {store.dtype}")
    return store.detach().cpu().contiguous().numpy().view(np.uint32)
