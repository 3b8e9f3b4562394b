"""Dataset-shape-aware engine planner (partial copy of
``spark_fsm_tpu/service/planner.py``: ``PlannerDecision``,
``choose_patterns_engine`` and ``choose_representation``).

- A patterns request goes to the SPAM wave engine when the frequent
  alphabet is at most ``MAX_ALPHABET`` and the density of the frequent
  projection (``data/vertical.dataset_stats``) is at least
  ``DENSITY_CROSSOVER``; else to the SPADE engine.  The port mines no
  maxgap/maxwindow constraint, so the reference's constrained branch is
  not copied.
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


def choose_patterns_engine(stats: vertical.DatasetStats) -> PlannerDecision:
    """The patterns-family crossover over a DatasetStats at the module
    defaults; pure."""
    x = float(DENSITY_CROSSOVER)
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
