"""Streaming windows — port of ``spark_fsm_tpu/streaming``: a window of
sequence micro-batches with count-based eviction, kept mined after every
push by re-mining (``WindowMiner``) or incrementally
(``IncrementalWindowMiner``), and the pull-based micro-batch consumer
(``PollConsumer``; ``streaming/kafka.py`` is the optional Kafka source,
importable without the client library)."""

from spark_fsm_tpu_torch.streaming.consumer import PollConsumer, StopConsumer
from spark_fsm_tpu_torch.streaming.incremental import IncrementalWindowMiner
from spark_fsm_tpu_torch.streaming.window import SlidingWindow, WindowMiner

__all__ = ["IncrementalWindowMiner", "PollConsumer", "SlidingWindow",
           "StopConsumer", "WindowMiner"]
