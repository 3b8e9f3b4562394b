"""Canonical ordering + serialization of mined patterns and rules (copy of
``spark_fsm_tpu/utils/canonical.py``: ``sort_patterns``, ``patterns_text``,
``diff_patterns``, and for TSR ``RuleResult``, ``sort_rules``,
``rule_line``, ``rules_text``).

Byte-identical parity between the oracle and the engines is defined over
this text form::

    <item> <item> ... -1 <item> ... -1 #SUP: <support>

one pattern per line, items ascending within an itemset, patterns sorted by
(#itemsets, total #items, the pattern tuple itself).
"""

from __future__ import annotations

import functools
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


# A rule X ==> Y keeps its confidence exact as the integer pair (sup, sup_x),
# so the canonical text is float-free.  Top-k is tie-inclusive: every rule
# with conf >= minconf and sup >= s_k (the k-th highest qualifying support).
RuleResult = Tuple[Tuple[int, ...], Tuple[int, ...], int, int]  # X, Y, sup, sup_x


def sort_rules(rules: Iterable[RuleResult]) -> List[RuleResult]:
    """Support descending, then confidence descending compared exactly
    (s1/x1 > s2/x2 <=> s1*x2 > s2*x1), then (X, Y) ascending."""
    def cmp(a: RuleResult, b: RuleResult) -> int:
        if a[2] != b[2]:
            return -1 if a[2] > b[2] else 1
        lhs, rhs = a[2] * b[3], b[2] * a[3]
        if lhs != rhs:
            return -1 if lhs > rhs else 1
        return -1 if (a[0], a[1]) < (b[0], b[1]) else (1 if (a[0], a[1]) > (b[0], b[1]) else 0)

    return sorted(rules, key=functools.cmp_to_key(cmp))


def rule_line(rule: RuleResult) -> str:
    x, y, sup, supx = rule
    return (f"{' '.join(map(str, x))} ==> {' '.join(map(str, y))} "
            f"#SUP: {sup} #CONF: {sup}/{supx}")


def rules_text(rules: Iterable[RuleResult]) -> str:
    return "\n".join(rule_line(r) for r in sort_rules(rules)) + "\n"


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
