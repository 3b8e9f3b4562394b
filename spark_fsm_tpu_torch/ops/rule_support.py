"""TSR rule supports — port of ``spark_fsm_tpu/ops/pallas_tsr.py``.

For a batch of candidate rules X => Y, given as ``xy[c, 0, :]`` (rows of
X) and ``xy[c, 1, :]`` (rows of Y), ``km`` slots each with -1 = unused:
A = AND of X's rows of the prefix-or store ``p1``, Y = AND of Y's rows of
the suffix-or store ``s1``; ``out[0, c]`` = #sequences where any word of
``shift_up_one(A) & Y`` is nonzero (sup(X => Y)), ``out[1, c]`` =
#sequences where A is nonzero (sup(X)).  The stores are the engine's flat
``[M+1, S*W]`` int32 layout (word minor, uint32 bits) whose last row M is
all ones: the AND identity a -1 slot stands for.

Two versions of the same function live here:
- the CUDA kernel ``csrc/rule_support.cu`` (built for sm_90a at first use,
  see ``_build.py``), which :func:`rule_supports` launches for CUDA
  tensors — it launches the kernel or raises, never falls back.  It has
  two paths, both kernels: a staged one for one-word sequences, km on the
  ladder and stores small enough to stage (:func:`staged_max_rows`), and
  a walk through L2 for everything else;
- :func:`rule_supports_plain`, the gather-and-fold of the reference's jnp
  evaluator (``spark_fsm_tpu/models/tsr.py`` ``_eval_kernel``) chunked over
  candidates, which :func:`rule_supports` uses for CPU tensors, which the
  engine runs on either device when it is pinned to it, and which the
  tests and ``chip_smoke.py`` hold the kernel against.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from spark_fsm_tpu_torch.ops import _build
from spark_fsm_tpu_torch.ops import bitops_torch as B

# the plain version's [chunk, S*W] gather temporaries stay near this size
_CHUNK_BYTES = 256 << 20


def _check(p1: torch.Tensor, s1: torch.Tensor, xy: torch.Tensor,
           n_words: int) -> None:
    for name, t in (("p1", p1), ("s1", s1), ("xy", xy)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != p1.device:
            raise ValueError(f"p1 on {p1.device} but {name} on {t.device}")
    if p1.dim() != 2 or p1.shape != s1.shape:
        raise ValueError(f"p1 and s1 must be flat [M+1, S*W] of one shape, got "
                         f"{tuple(p1.shape)} and {tuple(s1.shape)}")
    if p1.shape[0] < 1:
        raise ValueError("the stores need at least the all-ones pad row")
    if n_words < 1 or p1.shape[1] % n_words:
        raise ValueError(f"row width {p1.shape[1]} is not a multiple of "
                         f"n_words={n_words}")
    if xy.dim() != 3 or xy.shape[1] != 2 or xy.shape[2] < 1:
        raise ValueError(f"xy must be [C, 2, km], got {tuple(xy.shape)}")


def rule_supports_plain(p1: torch.Tensor, s1: torch.Tensor, xy: torch.Tensor,
                        n_words: int = 1) -> torch.Tensor:
    """The plain PyTorch version: ``[2, C]`` int32 (sup, supx).  Gathers
    each candidate's rows (a -1 slot reads the pad row M), folds them with
    AND, and works through the candidates in chunks so the ``[chunk, S*W]``
    temporaries stay near ``_CHUNK_BYTES``."""
    _check(p1, s1, xy, n_words)
    rows, sw = p1.shape
    C, _, km = xy.shape
    s = sw // n_words
    idx = torch.where(xy < 0, rows - 1, xy).long()
    out = torch.empty(2, C, dtype=torch.int32, device=p1.device)
    cc = max(1, _CHUNK_BYTES // max(1, sw * 4))
    for lo in range(0, C, cc):
        ix = idx[lo:lo + cc]
        a = p1[ix[:, 0, 0]]
        y = s1[ix[:, 1, 0]]
        for j in range(1, km):
            a &= p1[ix[:, 0, j]]
            y &= s1[ix[:, 1, j]]
        a = a.view(-1, s, n_words)
        out[0, lo:lo + cc] = B.support(B.shift_up_one(a) & y.view(-1, s, n_words))
        out[1, lo:lo + cc] = B.support(a)
    return out


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = _build.load("rule_support")
    fn = lib.rule_support_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def staged_max_rows(km: int) -> int:
    """The largest M (store rows less the pad row) for which a one-word
    launch at this km takes the kernel's staged path (all rows of a
    32-sequence chunk in shared memory); larger M, W > 1 and a km off the
    ladder take its walk path.  0 when km has no staged path."""
    fn = _build.load("rule_support").rule_support_staged_max_rows
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_int
    return int(fn(int(km)))


def rule_supports(p1: torch.Tensor, s1: torch.Tensor, xy: torch.Tensor,
                  n_words: int = 1) -> torch.Tensor:
    """``[2, C]`` int32 rule supports (row 0 sup(X => Y), row 1 sup(X)).
    CUDA tensors launch the kernel (and raise if it cannot be built or
    launched); CPU tensors take :func:`rule_supports_plain`; any other
    device raises.  Entries of ``xy`` must lie in -1..M-1: the kernel
    stops with a device fault on any other, as PyTorch's own index checks
    do.  Each launch adds one to ``rule_supports.launches``."""
    _check(p1, s1, xy, n_words)
    dev = p1.device
    if dev.type == "cpu":
        return rule_supports_plain(p1, s1, xy, n_words)
    if dev.type != "cuda":
        raise ValueError(f"rule_supports runs on cuda (kernel) or cpu "
                         f"(plain version), got {dev}")
    C, _, km = xy.shape
    S = p1.shape[1] // n_words
    out = torch.zeros(2, C, dtype=torch.int32, device=dev)
    if C == 0 or S == 0:
        return out
    fn = _kernel()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(p1.data_ptr(), s1.data_ptr(), xy.data_ptr(), out.data_ptr(), C,
            km, S, n_words, p1.shape[0], stream)
    if rc != 0:
        raise RuntimeError(
            f"rule_support kernel launch failed: CUDA error {rc} (error 1, "
            f"invalid value, is also a km={km} above the kernel's 64 or, on "
            f"the walk path, an S={S} past the grid's 65,535 sequence "
            f"chunks)")
    rule_supports.launches += 1
    return out


rule_supports.launches = 0
