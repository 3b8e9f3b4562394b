"""SPMF sequence-format parser / writer (copy of ``spark_fsm_tpu/data/spmf.py``;
with ``fingerprint_db`` and ``file_validator``, the service's dataset
identities).

Kept as a copy because the port imports nothing of the reference package.
One sequence per line; itemsets are groups of space-separated positive
integer item ids; ``-1`` terminates an itemset; ``-2`` terminates the
sequence.  Example::

    1 3 -1 2 -1 2 4 -2      # <{1,3},{2},{2,4}>

In-memory representation: ``list[Sequence]`` where ``Sequence =
tuple[Itemset, ...]`` and ``Itemset = tuple[int, ...]`` with items sorted
ascending.
"""

from __future__ import annotations

import hashlib
import os
from typing import Iterable, List, Optional, Tuple

Itemset = Tuple[int, ...]
Sequence = Tuple[Itemset, ...]
SequenceDB = List[Sequence]


def fingerprint_db(db: Iterable[Sequence]) -> str:
    """Content-addressed dataset fingerprint: a streaming sha256 over the
    canonical in-memory form (itemsets deduped + sorted by the parser),
    one sequence at a time — never materializing the whole text.

    Deliberately hashes CONTENT ONLY, not the source spelling: a FILE
    path, an INLINE payload, and a SYNTH generator that resolve to the
    same sequences produce the SAME fingerprint, which is exactly what
    lets the result-reuse tier (service/resultcache.py) serve one
    cached mine to every spelling of the data.  The checkpoint layer's
    engine fingerprints cover engine state; this covers the dataset
    dimension.
    """
    h = hashlib.sha256(b"fsm-db-v1\n")
    for seq in db:
        parts: List[str] = []
        for itemset in seq:
            parts.extend(str(i) for i in itemset)
            parts.append("-1")
        parts.append("-2\n")
        h.update(" ".join(parts).encode("ascii"))
    return h.hexdigest()


def file_validator(path: str,
                   sample_bytes: int = 65536) -> Optional[dict]:
    """Cheap immutability witness for a FILE artifact: mtime (ns) +
    size + a sha256 over a head/tail content sample.  Two calls that
    return EQUAL dicts prove — to the strength an immutable-artifact
    deployment needs — that the path still names the bytes it named
    before, without re-reading a multi-GB dataset.

    This is what lets the result-reuse tier (service/resultcache.py)
    resolve a FILE-spelling request's content fingerprint AT ADMISSION
    (unlocking dominance serving for the FILE spelling, ROADMAP 2b):
    the learned path→fingerprint mapping is trusted only while the
    validator matches; any mismatch — touched file, rewritten file,
    same-size in-place edit inside the sampled windows — falls back to
    the mutable path (coalesce-only), never serves stale results.  An
    adversarial same-mtime same-size edit OUTSIDE the sampled windows
    can defeat it, which is why it gates REUSE, never correctness of a
    cold mine.  None when the path cannot be statted/read (the caller
    degrades to the mutable path)."""
    try:
        st = os.stat(path)
        h = hashlib.sha256()
        with open(path, "rb") as fh:
            h.update(fh.read(sample_bytes))
            if st.st_size > sample_bytes:
                # tail window, starting past the head so files up to
                # 2x sample_bytes are covered in full
                fh.seek(max(sample_bytes, st.st_size - sample_bytes))
                h.update(fh.read(sample_bytes))
        return {"mtime_ns": int(st.st_mtime_ns),
                "size": int(st.st_size),
                "sample": h.hexdigest()}
    except OSError:
        return None


def parse_spmf(text: str) -> SequenceDB:
    """Parse SPMF sequence format into a list of tuple-of-itemset sequences.

    Blank lines and comment/header lines (``#``, and ARFF-style ``@``/``%``
    headers found in SPMF-converted files) are skipped.  A line may omit the
    trailing ``-2``; a trailing ``-1`` before ``-2`` is optional.  Item ids
    must be positive integers.
    """
    db: SequenceDB = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith(("#", "@", "%")):
            continue
        seq: List[Itemset] = []
        cur: List[int] = []
        for tok in line.split():
            v = int(tok)
            if v == -2:
                break
            if v == -1:
                if cur:
                    seq.append(tuple(sorted(set(cur))))
                    cur = []
            else:
                if v <= 0:
                    raise ValueError(f"item ids must be positive, got {v!r} in line {line!r}")
                cur.append(v)
        if cur:
            seq.append(tuple(sorted(set(cur))))
        if seq:
            db.append(tuple(seq))
    return db


def format_spmf(db: Iterable[Sequence]) -> str:
    """Serialize a sequence database back to SPMF text (with -1/-2 markers)."""
    lines = []
    for seq in db:
        parts: List[str] = []
        for itemset in seq:
            parts.extend(str(i) for i in itemset)
            parts.append("-1")
        parts.append("-2")
        lines.append(" ".join(parts))
    return "\n".join(lines) + ("\n" if lines else "")


def load_spmf(path: str) -> SequenceDB:
    with open(path, "r", encoding="utf-8") as f:
        return parse_spmf(f.read())
