"""Checksummed self-describing envelope for every durable store write
.

Until this layer existed, every durable artifact — checkpoint metas and
delta chunks, journal intents, rescache entries, trace-spine chunks,
lease heartbeats, autoscale records — was trusted blindly on read: a
single flipped bit in a checkpoint delta silently resumed a wrong
frontier, and a corrupt rescache entry was amplified by dominance
serving to every future request for that fingerprint.  The envelope
makes corruption *detectable* at each read site, so each surface can
degrade by its own blast radius (service/integrity.py owns the
per-surface posture; this module owns only the bytes).

Wire format (text-safe — every store value in this system is a str)::

    FSME1:<sha256-hex 64>:<payload-len decimal>:<payload>

* ``FSME`` — magic; a value not starting with it is a *legacy*
  (pre-envelope) value, accepted as ``verify=legacy`` and upgraded the
  next time its writer rewrites it.  No flag-day migration.
* ``1`` — schema version.  An envelope with an UNKNOWN version is
  treated as corrupt, not legacy: we know it claims to be checked but
  cannot check it, and integrity must fail loud, not open.
* sha256 over the UTF-8 payload bytes, computed in streaming chunks so
  multi-MB rescache entries never need a second contiguous copy.
* explicit payload length — catches truncation even when the truncated
  tail happens to re-hash (it cannot, but the length check is free and
  fails faster than the digest on short reads).

The clean-path cost contract (pinned by bench_smoke's byte-identical
dispatch counters): ONE sha256 verify per durable read, zero extra
store round-trips.

Port: a copy of ``spark_fsm_tpu/utils/envelope.py`` with its imports pointed at ``spark_fsm_tpu_torch``.
"""
from __future__ import annotations

import hashlib
import re
from typing import Optional, Tuple

MAGIC = "FSME"
VERSION = 1
_PREFIX = f"{MAGIC}{VERSION}:"
# header: magic+version, 64 hex digest chars, decimal length, then payload
_HEADER = re.compile(r"^FSME(\d+):([0-9a-f]{64}):(\d+):")
# streaming digest chunk: 1 MiB of UTF-8 bytes per update
_CHUNK = 1 << 20

#: verdicts `unwrap` can return (service/integrity.py seeds counters
#: over the first three; "missing" is a None value, not a read outcome)
VERDICTS = ("ok", "legacy", "corrupt")


def _digest(payload: str) -> str:
    h = hashlib.sha256()
    data = payload.encode("utf-8")
    for i in range(0, len(data), _CHUNK):
        h.update(data[i:i + _CHUNK])
    return h.hexdigest()


def wrap(payload: str) -> str:
    """Envelope ``payload`` for a durable write."""
    return f"{_PREFIX}{_digest(payload)}:{len(payload)}:{payload}"


def is_enveloped(value: Optional[str]) -> bool:
    return isinstance(value, str) and value.startswith(MAGIC)


def unwrap(value: Optional[str]) -> Tuple[Optional[str], str]:
    """Verified open of a durable value: ``(payload, verdict)``.

    * ``(payload, "ok")``     — intact envelope, digest + length check out.
    * ``(value, "legacy")``   — pre-envelope value: returned untouched so
      existing parsers keep working; the writer upgrades it on next write.
    * ``(None, "corrupt")``   — claims to be enveloped but fails the
      header parse, version check, length, or digest.  The caller must
      degrade per its surface's posture, never parse the bytes.
    * ``(None, "missing")``   — value was None (key absent).
    """
    if value is None:
        return None, "missing"
    if not isinstance(value, str):
        # non-str values never come out of the store layer; treat as
        # legacy so an exotic caller degrades through its own parser
        return value, "legacy"
    if not value.startswith(MAGIC):
        return value, "legacy"
    m = _HEADER.match(value)
    if m is None:
        return None, "corrupt"  # truncated or garbled header
    if int(m.group(1)) != VERSION:
        return None, "corrupt"  # claims a schema we cannot verify
    payload = value[m.end():]
    if len(payload) != int(m.group(3)):
        return None, "corrupt"  # truncation (or tail growth)
    if _digest(payload) != m.group(2):
        return None, "corrupt"  # bit rot
    return payload, "ok"
