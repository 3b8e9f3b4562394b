"""Device resolution for the port's entry points.

The default is ``cuda``.  The CPU is used only when the caller asks for
it (the CPU tests pass ``device="cpu"``); a missing card raises instead of
quietly running the plain path on the host.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> the current CUDA device; ``"cpu"`` -> the CPU; any
    other device type is refused.  Raises ``RuntimeError`` when CUDA is
    requested (explicitly or by default) and torch sees no CUDA device."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is "
            "False (no CUDA device); pass device='cpu' to run the plain "
            "PyTorch path on the host")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
