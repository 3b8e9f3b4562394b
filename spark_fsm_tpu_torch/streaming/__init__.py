"""Streaming windows — port of ``spark_fsm_tpu/streaming``: a window of
sequence micro-batches with count-based eviction, kept mined after every
push by re-mining (``WindowMiner``) or incrementally
(``IncrementalWindowMiner``).  The reference's poll consumer and Kafka
source are not ported yet (ROADMAP Queue A item 13)."""

from spark_fsm_tpu_torch.streaming.incremental import IncrementalWindowMiner
from spark_fsm_tpu_torch.streaming.window import SlidingWindow, WindowMiner

__all__ = ["IncrementalWindowMiner", "SlidingWindow", "WindowMiner"]
