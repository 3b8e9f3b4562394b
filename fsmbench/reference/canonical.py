"""The canonical order of mined patterns: a frozen copy of
``sort_patterns`` from ``spark_fsm_tpu_torch/utils/canonical.py`` at
commit af584b40603189c27f03b8d906643a82cdb45648.  Patterns sort by
(#itemsets, total #items, the pattern tuple itself)."""

from __future__ import annotations

from typing import Iterable, List, Tuple

Pattern = Tuple[Tuple[int, ...], ...]
PatternResult = Tuple[Pattern, int]


def sort_patterns(results: Iterable[PatternResult]) -> List[PatternResult]:
    return sorted(results, key=lambda r: (len(r[0]), sum(len(s) for s in r[0]), r[0]))
