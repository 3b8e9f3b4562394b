"""Dataset-shape-aware engine planner (partial copy of
``spark_fsm_tpu/service/planner.py``: ``PlannerDecision``,
``choose_patterns_engine``, the pinned-SPAM constrained fallback of
``choose`` as :func:`choose_pinned` and ``choose_representation``).

- A patterns request goes to the SPAM wave engine when the frequent
  alphabet is at most ``MAX_ALPHABET`` and the density of the frequent
  projection (``data/vertical.dataset_stats``) is at least
  ``DENSITY_CROSSOVER``; else to the SPADE engine.  A request with
  maxgap/maxwindow constraints goes to SPADE (its constrained engine,
  ``models/spade_constrained.py``), whatever the data: SPAM serves
  unconstrained patterns only, so a pinned SPAM falls back to it too.
- Within a SPAM mine, the same crossover picks each item's representation
  (dense bitmap row or id-list), and ``DIFFSET_DEPTH`` the pattern length
  from which supports take the dEclat diffset spelling.

The defaults are the reference's ``[planner]`` configuration
(``config.PlannerConfig``).  The config file, trace spans and counters
belong to the service seam, which is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from spark_fsm_tpu_torch.data import vertical

DENSITY_CROSSOVER = 0.02
MAX_ALPHABET = 512
REPRESENTATION = "auto"
DIFFSET_DEPTH = 3


@dataclasses.dataclass(frozen=True)
class PlannerDecision:
    engine: str
    kind: str
    mode: str           # "auto" | "pinned"
    reason: str
    density: Optional[float] = None
    alphabet: Optional[int] = None
    crossover: Optional[float] = None


def choose_patterns_engine(stats: vertical.DatasetStats,
                           constrained: bool = False) -> PlannerDecision:
    """The patterns-family crossover over a DatasetStats at the module
    defaults; pure."""
    x = float(DENSITY_CROSSOVER)
    if constrained:
        return PlannerDecision(
            "SPADE_TPU", "patterns", "auto",
            "maxgap/maxwindow constraints (SPAM serves unconstrained "
            "patterns only)")
    if stats.alphabet > MAX_ALPHABET:
        return PlannerDecision(
            "SPADE_TPU", "patterns", "auto",
            f"alphabet {stats.alphabet} > max_alphabet "
            f"{MAX_ALPHABET} (full-item-axis waves would be "
            f"mostly dead lanes)",
            density=stats.density, alphabet=stats.alphabet, crossover=x)
    if stats.density >= x:
        return PlannerDecision(
            "SPAM_TPU", "patterns", "auto",
            f"density {stats.density} >= crossover {x}",
            density=stats.density, alphabet=stats.alphabet, crossover=x)
    return PlannerDecision(
        "SPADE_TPU", "patterns", "auto",
        f"density {stats.density} < crossover {x}",
        density=stats.density, alphabet=stats.alphabet, crossover=x)


def choose_pinned(engine: str, kind: str,
                  constrained: bool = False) -> PlannerDecision:
    """A pinned patterns engine: the pin, except that a constrained
    request pinned to SPAM falls back to SPADE (SPAM cannot serve
    maxgap/maxwindow)."""
    if constrained and engine in ("SPAM", "SPAM_TPU"):
        return PlannerDecision(
            "SPADE_TPU", kind, "pinned",
            f"pinned engine {engine} cannot serve "
            f"maxgap/maxwindow — constrained fallback to SPADE_TPU")
    return PlannerDecision(engine, kind, "pinned",
                           f"[planner] mode=pinned -> {engine}")


def choose_representation(item_supports, n_sequences: int, *,
                          pin: Optional[str] = None,
                          crossover: Optional[float] = None,
                          diffset_depth: Optional[int] = None):
    """Per-item representation routing within a mine: returns
    ``(vertical.RepPlan, diffset_depth)``; each argument left None takes
    its module default."""
    pin = REPRESENTATION if pin is None else pin
    x = DENSITY_CROSSOVER if crossover is None else crossover
    dd = DIFFSET_DEPTH if diffset_depth is None else diffset_depth
    plan = vertical.rep_plan(item_supports, n_sequences,
                             crossover=float(x), pin=pin)
    return plan, int(dd)
