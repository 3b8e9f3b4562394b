"""Kafka adapter: a ``poll()``-shaped client -> PollConsumer's fetch.

SURVEY.md sec 2.5 names "Kafka micro-batches" as the reference
ecosystem's streaming feed; sec 7 step 9 keeps the client optional
behind the source interface.  No broker (or client library) is assumed
reachable, so the adapter binds to the SHAPE of the de-facto
Python clients instead of importing one:

    consumer.poll(timeout_ms=...) -> {partition: [record, ...], ...}

where each record carries the payload in ``.value`` (kafka-python) —
bytes or str of SPMF sequence lines, one or more per record.  Both
kafka-python's ``KafkaConsumer`` and confluent-kafka wrapped to this
dict shape satisfy it; the contract tests run against a fake, and a
production deployment does::

    from kafka import KafkaConsumer          # external, optional extra
    consumer = KafkaConsumer("clicks", bootstrap_servers=..., ...)
    PollConsumer(KafkaFetch(consumer), miner.push).run()

Semantics (PollConsumer's fetch contract):
- an empty poll returns None (idle — the loop sleeps and re-polls);
- all records of one poll concatenate into ONE micro-batch, preserving
  partition-list order (a micro-batch is "whatever this poll returned",
  the reference's Spark-Streaming batching analog);
- undecodable/unparseable records follow ``on_bad``: "raise" (default)
  surfaces the error to PollConsumer's supervision counters, "skip"
  drops the record and counts it in ``stats["bad_records"]`` — a
  poisoned topic must be a visible choice, never a silent one.

Port: a copy of ``spark_fsm_tpu/streaming/kafka.py`` with its imports pointed at ``spark_fsm_tpu_torch``.
"""

from __future__ import annotations

from typing import Callable, Optional

from spark_fsm_tpu_torch.data.spmf import SequenceDB, parse_spmf
from spark_fsm_tpu_torch.utils import faults, obs

_BAD_RECORDS = obs.REGISTRY.counter(
    "fsm_kafka_bad_records_total",
    "records that failed to decode/parse (both on_bad modes)")

# dead-letter ring: the last N undecodable payloads are kept in stats
# (truncated, with partition/offset when the record exposes one) so a
# poisoned topic is DIAGNOSABLE from /admin or the consumer's stats —
# a bare bad_records count tells an operator something is wrong but not
# what, which producer, or where to replay from
DEAD_LETTER_RING = 16
DEAD_LETTER_PAYLOAD_CHARS = 160


class KafkaFetch:
    """Adapt a kafka-python-shaped consumer to ``PollConsumer`` fetch.

    Args:
      consumer: object with ``poll(timeout_ms=int) -> dict`` mapping
        partitions to record lists; records expose ``.value``.
      timeout_ms: handed to every ``poll`` call.
      decode: bytes -> str for record values (default strict UTF-8).
      parse: text -> SequenceDB (default SPMF parser).
      on_bad: "raise" (default) or "skip" for records that fail to
        decode or parse.
    """

    def __init__(self, consumer, *, timeout_ms: int = 500,
                 decode: Callable[[bytes], str] = None,
                 parse: Callable[[str], SequenceDB] = None,
                 on_bad: str = "raise") -> None:
        if on_bad not in ("raise", "skip"):
            raise ValueError(f"on_bad must be 'raise' or 'skip' "
                             f"(got {on_bad!r})")
        if not hasattr(consumer, "poll"):
            raise TypeError("consumer must expose poll(timeout_ms=...) "
                            f"(got {type(consumer).__name__})")
        self._consumer = consumer
        self.timeout_ms = int(timeout_ms)
        self._decode = decode or (lambda b: b.decode("utf-8"))
        self._parse = parse or parse_spmf
        self.on_bad = on_bad
        self.stats = {"polls": 0, "records": 0, "bad_records": 0,
                      "dead_letters": []}

    def _dead_letter(self, partition, rec, exc: Exception) -> None:
        """Ring-buffer the undecodable record (both on_bad modes: a
        raised poison message is just as worth diagnosing as a skipped
        one).  Payloads are truncated — the ring is for diagnosis, not
        for replaying multi-MB blobs through a stats endpoint."""
        payload = repr(getattr(rec, "value", None))
        if len(payload) > DEAD_LETTER_PAYLOAD_CHARS:
            payload = payload[:DEAD_LETTER_PAYLOAD_CHARS] + "...(truncated)"
        ring = self.stats["dead_letters"]
        ring.append({
            "partition": str(partition),
            "offset": getattr(rec, "offset", None),
            "payload": payload,
            "error": f"{type(exc).__name__}: {exc}",
        })
        del ring[:-DEAD_LETTER_RING]
        _BAD_RECORDS.inc()
        obs.trace_event("kafka_dead_letter", partition=str(partition),
                        offset=getattr(rec, "offset", None),
                        error=f"{type(exc).__name__}: {exc}")

    def __call__(self) -> Optional[SequenceDB]:
        self.stats["polls"] += 1
        faults.fault_site("kafka.poll", timeout_ms=str(self.timeout_ms))
        recs = self._consumer.poll(timeout_ms=self.timeout_ms)
        if not recs:
            return None
        batch: SequenceDB = []
        n_rec = 0
        for partition, records in recs.items():
            for rec in records:
                n_rec += 1
                try:
                    value = rec.value
                    text = (self._decode(value)
                            if isinstance(value, (bytes, bytearray))
                            else value)
                    batch.extend(self._parse(text))
                except Exception as exc:
                    self._dead_letter(partition, rec, exc)
                    if self.on_bad == "raise":
                        raise
                    self.stats["bad_records"] += 1
        self.stats["records"] += n_rec
        return batch or None
