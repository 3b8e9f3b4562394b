"""PyTorch/CUDA port of ``spark_fsm_tpu`` (the JAX package is the reference).

The layout mirrors the reference package, so each module has a
counterpart of the same name there, and each module's docstring names
the file it ports.  The port imports ``torch`` and numpy, never ``jax``
and nothing of ``spark_fsm_tpu``: the framework-free modules it needs
(``data/*``, ``utils/canonical.py``, ``ops/bitops_np.py``,
``models/oracle.py``, ``ops/maxstart_np.py``, ``service/planner.py``,
``service/model.py``'s serializers) are kept here as copies.

Bitmaps live as ``torch.int32`` tensors holding the same bits as the
reference's ``uint32`` arrays (``arr.view(np.int32)`` in,
``.view(np.uint32)`` out).  Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``; without CUDA they raise instead of falling back.
"""

from spark_fsm_tpu_torch.data.spmf import SequenceDB, load_spmf, parse_spmf
from spark_fsm_tpu_torch.data.vertical import VerticalDB, abs_minsup, build_vertical
from spark_fsm_tpu_torch.models.spade import SpadeTorch, mine_spade_torch
from spark_fsm_tpu_torch.models.spade_fused import FusedSpadeTorch
from spark_fsm_tpu_torch.models.spade_constrained import (
    ConstrainedSpadeTorch, mine_cspade_torch)
from spark_fsm_tpu_torch.models.spade_queue import QueueSpadeTorch
from spark_fsm_tpu_torch.models.spam_bitmap import SpamBitmapTorch, mine_spam_torch
from spark_fsm_tpu_torch.models.tsr import TsrTorch, mine_tsr_torch
from spark_fsm_tpu_torch.ops.rule_trie import (
    build_trie, predict_host, rules_from_patterns, score_wave)
from spark_fsm_tpu_torch.streaming import (
    IncrementalWindowMiner, SlidingWindow, WindowMiner)

__all__ = [
    "SequenceDB", "load_spmf", "parse_spmf",
    "VerticalDB", "abs_minsup", "build_vertical",
    "SpadeTorch", "QueueSpadeTorch", "FusedSpadeTorch", "mine_spade_torch",
    "ConstrainedSpadeTorch", "mine_cspade_torch",
    "SpamBitmapTorch", "mine_spam_torch",
    "TsrTorch", "mine_tsr_torch",
    "IncrementalWindowMiner", "SlidingWindow", "WindowMiner",
    "build_trie", "score_wave", "predict_host", "rules_from_patterns",
]
