"""SPMF sequence-format parser / writer (copy of ``spark_fsm_tpu/data/spmf.py``).

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

from typing import Iterable, List, Tuple

Itemset = Tuple[int, ...]
Sequence = Tuple[Itemset, ...]
SequenceDB = List[Sequence]


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
