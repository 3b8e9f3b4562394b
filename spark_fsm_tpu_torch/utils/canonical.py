"""Canonical ordering + serialization of mined patterns (copy of
``spark_fsm_tpu/utils/canonical.py``: ``sort_patterns``, ``patterns_text``,
``diff_patterns``).

Byte-identical parity between the oracle and the engines is defined over
this text form::

    <item> <item> ... -1 <item> ... -1 #SUP: <support>

one pattern per line, items ascending within an itemset, patterns sorted by
(#itemsets, total #items, the pattern tuple itself).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

Pattern = Tuple[Tuple[int, ...], ...]
PatternResult = Tuple[Pattern, int]


def sort_patterns(results: Iterable[PatternResult]) -> List[PatternResult]:
    return sorted(results, key=lambda r: (len(r[0]), sum(len(s) for s in r[0]), r[0]))


def pattern_line(pattern: Pattern, sup: int) -> str:
    parts: List[str] = []
    for itemset in pattern:
        parts.extend(str(i) for i in itemset)
        parts.append("-1")
    parts.append(f"#SUP: {sup}")
    return " ".join(parts)


def patterns_text(results: Iterable[PatternResult]) -> str:
    return "\n".join(pattern_line(p, s) for p, s in sort_patterns(results)) + "\n"


def diff_patterns(a: Iterable[PatternResult], b: Iterable[PatternResult], limit: int = 10) -> str:
    """Human-readable diff for parity failures (missing / extra / support mismatches)."""
    da: Dict[Pattern, int] = dict(a)
    db: Dict[Pattern, int] = dict(b)
    msgs: List[str] = []
    for p in sorted(set(da) - set(db), key=lambda p: (len(p), p))[:limit]:
        msgs.append(f"only in A: {pattern_line(p, da[p])}")
    for p in sorted(set(db) - set(da), key=lambda p: (len(p), p))[:limit]:
        msgs.append(f"only in B: {pattern_line(p, db[p])}")
    for p in sorted(set(da) & set(db), key=lambda p: (len(p), p)):
        if da[p] != db[p]:
            msgs.append(f"support mismatch {p}: A={da[p]} B={db[p]}")
            if len(msgs) >= 2 * limit:
                break
    return "\n".join(msgs) if msgs else "identical"
