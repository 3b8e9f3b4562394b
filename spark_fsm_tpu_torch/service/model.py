"""Result serialization (partial copy of ``spark_fsm_tpu/service/model.py``:
``serialize_patterns``, ``deserialize_patterns``, ``serialize_rules`` and
``deserialize_rules``).

The prediction plane's artifact cache keys on
``ops/rule_trie.rules_digest(payload)``, so these strings are the
reference's byte for byte.  The request/response model (``Status``,
``ServiceRequest``, ``ServiceResponse``, ``response``) belongs to the
service seam, which is not ported.
"""

from __future__ import annotations

import json
from typing import List

from spark_fsm_tpu_torch.utils.canonical import PatternResult, RuleResult


def serialize_patterns(patterns: List[PatternResult]) -> str:
    """FSMPattern list -> JSON: [{"support": N, "itemsets": [[...], ...]}]."""
    return json.dumps([
        {"support": int(sup), "itemsets": [list(s) for s in pat]}
        for pat, sup in patterns
    ])


def deserialize_patterns(text: str) -> List[PatternResult]:
    return [
        (tuple(tuple(int(i) for i in s) for s in obj["itemsets"]), int(obj["support"]))
        for obj in json.loads(text)
    ]


def serialize_rules(rules: List[RuleResult]) -> str:
    """FSMRule list -> JSON with exact confidence (sup/supx kept integral)."""
    return json.dumps([
        {
            "antecedent": list(x),
            "consequent": list(y),
            "support": int(sup),
            "antecedent_support": int(supx),
            "confidence": (int(sup) / int(supx)) if supx else 0.0,
        }
        for x, y, sup, supx in rules
    ])


def deserialize_rules(text: str) -> List[RuleResult]:
    return [
        (tuple(int(i) for i in obj["antecedent"]),
         tuple(int(i) for i in obj["consequent"]),
         int(obj["support"]), int(obj["antecedent_support"]))
        for obj in json.loads(text)
    ]
