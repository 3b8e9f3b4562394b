"""Dataset-shape-aware engine planner.

Sits between the algorithm registry and the engines: ``algorithm=AUTO``
requests are routed to a concrete engine by a calibrated crossover
model over the dataset's density/length stats
(``data/vertical.dataset_stats`` — computed once when the dataset is
admitted into the job, before the mine), explicit engine names are
always honored, and unknown names shed a structured 400 listing the
supported registry (service/model.py maps the exception).

The crossover model (docs/DESIGN.md "Engine planner" has the measured
table behind the default):

- **rules** requests (``k``/``minconf`` present) route to ``TSR_TPU``
  — SPAM serves the patterns family only.
- **patterns** requests route to ``SPAM_TPU`` when the dataset is
  DENSE enough that the fixed-shape all-items wave beats ragged
  candidate-list packing: ``density >= [planner] density_crossover``
  AND ``alphabet <= [planner] max_alphabet`` AND no maxgap/maxwindow
  constraints (the SPAM engine does not implement them).  Everything
  else routes to ``SPADE_TPU``.

``[planner] mode = "pinned"`` routes every AUTO to ``[planner]
pinned`` unconditionally — the operator lever for soaking one engine
or excluding a suspect one without touching clients.

Every decision lands in the trace spine as a zero-length
``planner.route`` span (attrs: engine, density, alphabet, reason), so
``/admin/trace/{uid}`` answers *why* an engine was picked, and bumps
``fsm_engine_selected_total{engine=...}`` (explicit routes bump it too,
from the Miner's run path — the counter is "which engine actually
mined", AUTO or not).

Port: a copy of ``spark_fsm_tpu/service/planner.py`` with its imports
pointed at ``spark_fsm_tpu_torch``, plus :func:`choose_pinned` (the pinned
branch of :func:`choose` as a pure function) and the ``[planner]``
defaults as module constants.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from spark_fsm_tpu_torch import config
from spark_fsm_tpu_torch.utils import obs
from spark_fsm_tpu_torch.utils.obs import log_event

# the concrete (routable) engines — the fsm_engine_selected_total label
# vocabulary, zero-seeded so a scrape shows every engine at 0 instead
# of no-data (the obs_smoke no-orphan contract)
CONCRETE_ENGINES = ("SPADE", "SPADE_TPU", "SPAM", "SPAM_TPU",
                    "TSR", "TSR_TPU")

_SELECTED = obs.REGISTRY.counter(
    "fsm_engine_selected_total",
    "train mines dispatched, by the engine that actually ran "
    "(AUTO requests count under the planner-resolved engine)")
for _e in CONCRETE_ENGINES:
    _SELECTED.seed(engine=_e)

# the ``[planner]`` defaults (config.PlannerConfig)
_DEFAULTS = config.PlannerConfig()
DENSITY_CROSSOVER = _DEFAULTS.density_crossover
MAX_ALPHABET = _DEFAULTS.max_alphabet
REPRESENTATION = _DEFAULTS.representation
DIFFSET_DEPTH = _DEFAULTS.diffset_depth


def count_selected(engine: str) -> None:
    if engine in CONCRETE_ENGINES:
        _SELECTED.inc(engine=engine)


def infer_kind(req) -> str:
    """AUTO's result kind is a pure function of the request params —
    rules when any TSR parameter is present, patterns otherwise — so
    coalescing identity (plugins.effective_params) is well-defined
    before any routing happens."""
    return ("rules" if (req.param("k") is not None
                        or req.param("minconf") is not None
                        or req.param("max_side") is not None)
            else "patterns")


@dataclasses.dataclass(frozen=True)
class PlannerDecision:
    engine: str
    kind: str
    mode: str           # "auto" | "pinned"
    reason: str
    density: Optional[float] = None
    alphabet: Optional[int] = None
    crossover: Optional[float] = None

    def as_attrs(self) -> dict:
        out = {"engine": self.engine, "kind": self.kind,
               "mode": self.mode, "reason": self.reason}
        if self.density is not None:
            out["density"] = self.density
        if self.alphabet is not None:
            out["alphabet"] = self.alphabet
        if self.crossover is not None:
            out["crossover"] = self.crossover
        return out


def choose_patterns_engine(stats, pcfg=None,
                           constrained: bool = False) -> PlannerDecision:
    """The calibrated patterns-family crossover over a DatasetStats —
    pure and deterministic (tests/test_planner.py pins a table of
    stats -> engine rows against it)."""
    pcfg = pcfg if pcfg is not None else config.get_config().planner
    x = float(pcfg.density_crossover)
    if constrained:
        return PlannerDecision(
            "SPADE_TPU", "patterns", "auto",
            "maxgap/maxwindow constraints (SPAM serves unconstrained "
            "patterns only)")
    if stats.alphabet > int(pcfg.max_alphabet):
        return PlannerDecision(
            "SPADE_TPU", "patterns", "auto",
            f"alphabet {stats.alphabet} > max_alphabet "
            f"{pcfg.max_alphabet} (full-item-axis waves would be "
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


def choose(req, db) -> PlannerDecision:
    """Route one AUTO request over a loaded dataset."""
    pcfg = config.get_config().planner
    kind = infer_kind(req)
    constrained = (req.param("maxgap") is not None
                   or req.param("maxwindow") is not None)
    if pcfg.mode == "pinned":
        engine = pcfg.pinned
        from spark_fsm_tpu_torch.service import plugins

        if plugins.ALGORITHMS[engine].kind != kind:
            # a pinned patterns engine cannot serve a rules request
            # (or vice versa): fall back to the kind's device default,
            # loudly — routing must never change the result kind
            fallback = "TSR_TPU" if kind == "rules" else "SPADE_TPU"
            return PlannerDecision(
                fallback, kind, "pinned",
                f"pinned engine {engine} serves "
                f"{plugins.ALGORITHMS[engine].kind}, request is {kind} "
                f"— kind-default fallback")
        return choose_pinned(engine, kind, constrained=constrained)
    if kind == "rules":
        return PlannerDecision("TSR_TPU", "rules", "auto",
                               "rules family (k/minconf present)")
    from spark_fsm_tpu_torch.data.vertical import dataset_stats
    from spark_fsm_tpu_torch.service.plugins import _minsup

    # density over the frequent-item projection at THIS request's
    # minsup — the item axis the routed engine will actually build
    stats = dataset_stats(db, min_item_support=_minsup(req, db))
    return choose_patterns_engine(stats, pcfg, constrained=constrained)


def choose_pinned(engine: str, kind: str,
                  constrained: bool = False) -> PlannerDecision:
    """A pinned engine of the request's kind: the pin, except that a
    constrained request pinned to SPAM falls back to SPADE — a SPAM soak
    must not fail every constrained AUTO request, since SPAM serves
    unconstrained patterns only."""
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
                          diffset_depth: Optional[int] = None,
                          engine: str = "spam"):
    """Per-item vertical-representation routing WITHIN a mine:
    the same calibrated density crossover that picks the engine picks,
    per item, dense SPAM bitmap vs SPADE id-list, and the pattern depth
    at which supports switch to the dEclat diffset formulation.

    Returns ``(data.vertical.RepPlan, diffset_depth)``.  Explicit
    arguments (engine kwargs, tests, benches) override the ``[planner]``
    config; every call lands a zero-length ``planner.representation``
    span on the trace spine — one record per mine explaining the whole
    per-item split (counts + density extremes + the crossover used), so
    ``/admin/trace/{uid}`` answers *why* each representation was chosen
    the same way ``planner.route`` answers the engine choice."""
    from spark_fsm_tpu_torch.data import vertical

    pcfg = config.get_config().planner
    pin = pcfg.representation if pin is None else pin
    x = pcfg.density_crossover if crossover is None else crossover
    dd = pcfg.diffset_depth if diffset_depth is None else diffset_depth
    plan = vertical.rep_plan(item_supports, n_sequences,
                             crossover=float(x), pin=pin)
    attrs = plan.as_attrs()
    attrs.update(engine=engine, diffset_depth=int(dd))
    with obs.span("planner.representation", **attrs):
        pass
    log_event("planner_representation", **attrs)
    return plan, int(dd)


def extract_auto(req, db, stats: Optional[dict] = None,
                 checkpoint=None):
    """The AUTO plugin body: choose, record the decision (trace spine +
    counter + job stats), delegate to the chosen engine's plugin with
    ``algorithm`` rewritten so every downstream param reader sees the
    concrete engine."""
    from spark_fsm_tpu_torch.service import plugins
    from spark_fsm_tpu_torch.service.model import ServiceRequest

    decision = choose(req, db)
    # the zero-length routing span rides the job's contextvar trace and
    # flushes to the durable spine with it — /admin/trace/{uid} shows
    # WHY the engine was picked even after a failover
    with obs.span("planner.route", **decision.as_attrs()):
        pass
    log_event("planner_route", uid=req.uid, **decision.as_attrs())
    count_selected(decision.engine)
    if stats is not None:
        stats["planner_engine"] = decision.engine
        stats["planner_mode"] = decision.mode
        stats["planner_reason"] = decision.reason
        if decision.density is not None:
            stats["planner_density"] = decision.density
    data = dict(req.data)
    data["algorithm"] = decision.engine
    routed = ServiceRequest(req.service, req.task, data)
    return plugins.ALGORITHMS[decision.engine].extract(
        routed, db, stats, checkpoint=checkpoint)
