"""Request/response model + JSON serialization.

Mirrors the reference's model layer (SURVEY.md sec 2: ``ServiceRequest(
service, task, data: Map[String,String])``, ``FSMPattern`` = support +
itemset list, ``FSMRule`` = antecedent/consequent/support/confidence, job
statuses ``started -> dataset -> trained/finished`` plus ``failure``) with
plain dataclasses and json — the contracts are the reference's, the
implementation is not.

Port: a copy of ``spark_fsm_tpu/service/model.py`` with its imports pointed at ``spark_fsm_tpu_torch``.
"""

from __future__ import annotations

import dataclasses
import json
import time
import uuid
from typing import Dict, List, Optional

from spark_fsm_tpu_torch.utils.canonical import PatternResult, RuleResult


class Status:
    """Job lifecycle constants (the reference's ResponseStatus vocabulary)."""

    STARTED = "started"
    DATASET = "dataset"
    TRAINED = "trained"
    FINISHED = "finished"
    FAILURE = "failure"


@dataclasses.dataclass
class ServiceRequest:
    """``(service, task, data)`` request envelope.

    ``data`` carries the per-request knobs as a flat string map exactly
    like the reference: ``uid``, ``algorithm`` (any name in
    ``service/plugins.ALGORITHMS`` — the SPADE/SPAM pattern engines,
    the TSR rule engines, and ``AUTO`` for planner routing; an unknown
    name sheds a structured 400 listing the registry), ``source``,
    ``support``, ``k``, ``minconf``, ``maxgap``, ``maxwindow``, plus
    source-specific fields.
    """

    service: str
    task: str
    data: Dict[str, str]

    @property
    def uid(self) -> str:
        return self.data.get("uid", "")

    def param(self, key: str, default: Optional[str] = None) -> Optional[str]:
        return self.data.get(key, default)

    @staticmethod
    def fresh_uid() -> str:
        return uuid.uuid4().hex

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @staticmethod
    def from_json(text: str) -> "ServiceRequest":
        obj = json.loads(text)
        return ServiceRequest(
            service=obj.get("service", "fsm"),
            task=obj.get("task", ""),
            data={str(k): str(v) for k, v in obj.get("data", {}).items()},
        )


@dataclasses.dataclass
class ServiceResponse:
    service: str
    task: str
    data: Dict[str, str]
    status: str

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))


def response(req: ServiceRequest, status: str, **extra: str) -> ServiceResponse:
    data = {"uid": req.uid}
    data.update(extra)
    return ServiceResponse(req.service, req.task, data, status)


# ---------------------------------------------------------------------------
# Result serialization (patterns / rules)
# ---------------------------------------------------------------------------

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
