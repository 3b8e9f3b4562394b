"""Algorithm plugin registry — the reference's L4 boundary.

The reference selects the miner by the request's ``algorithm`` param
through top-level plugin objects (``SPADE.extract``, ``TSR.extract`` —
SURVEY.md sec 1 L4, sec 3.1).  The rebuild keeps exactly that seam (the
``AlgorithmPlugin`` boundary named in BASELINE.json: ``algorithm=
SPADE_TPU``) over the TPU engines and the CPU oracles:

  SPADE      — CPU oracle miner (numpy bitmap DFS).
  SPADE_TPU  — device engine (models/spade_tpu.py); honors maxgap /
               maxwindow by switching to the constrained engine.
  SPAM       — CPU SPAM wave miner (models/spam_bitmap.py, popcount
               support formulation; unconstrained patterns only).
  SPAM_TPU   — device SPAM fixed-shape wave engine (same module).
  TSR        — CPU top-k rule miner (models/tsr.py TsrCPU: same best-first
               search, NumPy bitmap evaluation on host).
  TSR_TPU    — device TSR engine (models/tsr.py TsrTPU).
  AUTO       — dataset-shape-aware routing to one of the above by the
               engine planner (service/planner.py; earlier work).

Each plugin returns (kind, results) where kind is "patterns" or "rules".
An unknown name raises :class:`UnknownAlgorithm`, whose ``supported``
listing is derived from ``ALGORITHMS`` itself — the HTTP layer maps it
to a structured 400.

Port of ``spark_fsm_tpu/service/plugins.py``: the same registry names,
families and request vocabulary.  The ``*_TPU`` plugins run the port's
engines (``mine_spade_torch``, ``mine_cspade_torch``, ``mine_spam_torch``,
``mine_tsr_torch`` and the engine caches of ``service/devcache.py``) on
the service's device, which the boot resolves once (:func:`set_device`;
``cuda`` unless the caller asks for the CPU).  On the card they launch
the kernels or fail; nothing here falls back to a plain version.  The CPU
plugins run the port's copies of the host miners.  The partition count
counts controller processes as the reference's ``jax.process_count()``
does (:func:`_process_count`), and the mesh's ranks where the reference
counts its devices.  On a world of ranks the device plugins are mesh
calls (``service/meshcall.py``): the leader's call is replayed on every
other rank, so their collectives meet.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, List, Optional, Tuple, Union

from spark_fsm_tpu_torch import config
from spark_fsm_tpu_torch.data.spmf import SequenceDB
from spark_fsm_tpu_torch.device import DeviceLike, resolve_device
from spark_fsm_tpu_torch.data.vertical import abs_minsup
from spark_fsm_tpu_torch.service import meshcall
from spark_fsm_tpu_torch.service.model import ServiceRequest
from spark_fsm_tpu_torch.utils.canonical import PatternResult, RuleResult

Results = Union[List[PatternResult], List[RuleResult]]

_device = None  # the service's device, resolved once at boot


def set_device(device: DeviceLike = None):
    """Resolve and keep the device the device plugins mine on (``None``
    = the current CUDA device, raising without a card; ``"cpu"`` for
    tests).  Returns the resolved device."""
    global _device
    _device = resolve_device(device)
    return _device


def service_device():
    """The boot-resolved device, or the default (CUDA) when no boot ran."""
    return _device if _device is not None else set_device(None)


def _process_count() -> int:
    """Controller processes, as the reference's ``jax.process_count()``
    counts them: the hosts of a ``[distributed]`` world (one process a
    host), else 1.  A one-host world of ``[engine] mesh_devices`` ranks
    is the counterpart of the reference's single controller over that
    many devices, whatever its process count."""
    d = config.get_config().distributed
    if not d.enabled:
        return 1
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(d.num_processes or 1)


class UnknownAlgorithm(ValueError):
    """An ``algorithm`` name outside the registry.  Carries the
    registry-derived ``supported`` listing so the HTTP layer can shed a
    structured 400 naming what IS supported (the listing comes from
    ``ALGORITHMS`` itself, never a docstring — satellite contract of
    earlier work)."""

    def __init__(self, name: str, supported):
        self.name = name
        self.supported = sorted(supported)
        super().__init__(
            f"unknown algorithm {name!r} (supported: "
            f"{', '.join(self.supported)})")


@dataclasses.dataclass
class AlgorithmPlugin:
    """``extract(req, db, stats=None, checkpoint=None)``; a provided
    ``stats`` dict receives the engine's observability counters (SURVEY.md
    sec 5 metrics row); ``checkpoint`` (load/save/every_s) enables frontier
    resume where the engine supports it — SPADE_TPU (constrained or not:
    DFS stack) and TSR/TSR_TPU (best-first queue + current top-k); only
    the CPU-oracle SPADE plugin drops it (flagged in stats)."""

    name: str
    kind: str  # "patterns" | "rules"
    extract: Callable[..., Results]


def _minsup(req: ServiceRequest, db: SequenceDB) -> int:
    support = req.param("support")
    if support is None:
        raise ValueError("train request needs a 'support' parameter")
    rel = float(support)
    if rel >= 1.0:  # absolute count given directly
        return int(rel)
    return abs_minsup(rel, len(db))


def _constraints(req: ServiceRequest) -> Tuple[Optional[int], Optional[int]]:
    mg = req.param("maxgap")
    mw = req.param("maxwindow")
    return (int(mg) if mg is not None else None,
            int(mw) if mw is not None else None)


def resolved_partition_parts() -> int:
    """The partition count the boot config implies — ONE resolver
    shared by request routing and the prewarm envelope so the warmed
    and served 2-D layouts cannot drift.  0 = partitioning off.

    ``[partition] parts = 0`` auto-resolves: one partition per process
    in a multi-controller run (the hosts x seq contract), else 2 when
    the boot mesh splits evenly into two rows, else off (a single local
    device has no outer axis to scale over, an odd mesh no even split).
    An explicit parts that cannot split the topology degrades LOUDLY to
    unpartitioned (``partition_config_invalid`` log) instead of failing
    every train request at ``submeshes``."""
    pc = config.get_config().partition
    if not pc.enabled:
        return 0
    n_procs = _process_count()
    mesh = config.get_mesh()
    if pc.parts:
        # an explicit parts that cannot split the boot topology must
        # not 500 every train request (or abort boot inside prewarm's
        # enumerate): degrade to unpartitioned, loudly — the log line +
        # fsm_partition_plans_total flatlining at 0 are the operator
        # signals (OPERATIONS.md)
        parts = int(pc.parts)
        bad = None
        if n_procs > 1 and parts != n_procs:
            bad = (f"parts={parts} != process_count={n_procs} "
                   "(multi-controller needs one partition per process)")
        elif n_procs == 1 and mesh is not None and parts > 1 \
                and mesh.size % parts:
            bad = (f"parts={parts} does not divide the "
                   f"{mesh.size}-device mesh")
        if bad:
            from spark_fsm_tpu_torch.utils.obs import log_event

            log_event("partition_config_invalid", reason=bad)
            return 0
        return parts if _classes_cover(parts, pc.classes) else 0
    if n_procs > 1:
        return n_procs if _classes_cover(n_procs, pc.classes) else 0
    if mesh is not None and mesh.size >= 2 and mesh.size % 2 == 0:
        return 2 if _classes_cover(2, pc.classes) else 0
    return 0


def _classes_cover(parts: int, classes: int) -> bool:
    """classes >= parts or the LPT plan cannot give every partition a
    class; config validation only covers EXPLICIT parts, so the
    auto-resolved count (the process count on a big pod) must re-check
    here — and degrade loudly rather than let plan_partitions raise on
    every train request."""
    if classes >= parts:
        return True
    from spark_fsm_tpu_torch.utils.obs import log_event

    log_event("partition_config_invalid",
              reason=f"classes={classes} < resolved parts={parts}")
    return False


def _partition_kwargs() -> dict:
    parts = resolved_partition_parts()
    if parts < 2:
        return {}
    return {"partition_parts": parts,
            "partition_classes": config.get_config().partition.classes}


def _checkpoint_unsupported(checkpoint, name: str,
                            stats: Optional[dict]) -> None:
    """A requested checkpoint the selected engine cannot honor must be
    visible (job stats + log), not silently dropped."""
    if checkpoint is None:
        return
    from spark_fsm_tpu_torch.utils.obs import log_event

    log_event("checkpoint_unsupported", algorithm=name)
    if stats is not None:
        stats["checkpoint_unsupported"] = True


def _spade_cpu(req: ServiceRequest, db: SequenceDB,
               stats: Optional[dict] = None, checkpoint=None) -> Results:
    from spark_fsm_tpu_torch.models.oracle import mine_cspade, mine_spade

    _checkpoint_unsupported(checkpoint, "SPADE", stats)

    minsup = _minsup(req, db)
    maxgap, maxwindow = _constraints(req)
    if maxgap is None and maxwindow is None:
        results = mine_spade(db, minsup)
    else:
        results = mine_cspade(db, minsup, maxgap=maxgap, maxwindow=maxwindow)
    if stats is not None:
        stats["patterns"] = len(results)
    return results


def _spade_tpu(req: ServiceRequest, db: SequenceDB,
               stats: Optional[dict] = None, checkpoint=None) -> Results:
    from spark_fsm_tpu_torch.models.spade import mine_spade_torch
    from spark_fsm_tpu_torch.models.spade_constrained import \
        mine_cspade_torch

    minsup = _minsup(req, db)
    maxgap, maxwindow = _constraints(req)
    kwargs = config.engine_kwargs("pool_bytes", "node_batch",
                                  "pipeline_depth", "chunk", "recompute_chunk")
    mesh = config.get_mesh()
    dev = service_device()
    # Streaming pushes (task == "stream") re-mine a window whose geometry
    # drifts every micro-batch: pow2-bucket the device shapes (both
    # engines support the knob) so consecutive pushes reuse compiled
    # programs instead of recompiling per window size — same knob
    # WindowMiner's default mine uses.
    if req.task == "stream":
        kwargs["shape_buckets"] = True
    if maxgap is None and maxwindow is None:
        # fused routing is a plain-SPADE knob (the constrained engine has
        # no fused counterpart), so it must not reach mine_cspade_tpu
        fused_kw = config.engine_kwargs("fused")
        part_kw = _partition_kwargs()
        if part_kw and req.task != "stream":
            # partitioned mines bypass the engine cache: the route
            # builds one engine per partition row, which the single-
            # engine cache cannot hold (streaming pushes keep the plain
            # route — their windows re-mine batch-sized slices)
            return mine_spade_torch(db, minsup, device=dev, mesh=mesh,
                                    stats_out=stats, checkpoint=checkpoint,
                                    **part_kw, **fused_kw, **kwargs)
        if req.task != "stream":
            # repeat mines over identical data reuse the HBM store +
            # compiled engine (service/devcache.py) — checkpointed jobs
            # included: the cached engine holds only the immutable
            # store, and a resume seeds it from the snapshot (the
            # frontier fingerprint is validated first).  Stream
            # re-mines skip the cache (a sliding window's data changes
            # every push, so every push would insert a dead entry).
            from spark_fsm_tpu_torch.service.devcache import spade_engine_cache
            return spade_engine_cache.mine(db, minsup, device=dev,
                                           mesh=mesh, stats_out=stats,
                                           checkpoint=checkpoint,
                                           **fused_kw, **kwargs)
        return mine_spade_torch(db, minsup, device=dev, mesh=mesh,
                                stats_out=stats, checkpoint=checkpoint,
                                **fused_kw, **kwargs)
    part_kw = _partition_kwargs()
    if part_kw and req.task != "stream":
        return mine_cspade_torch(db, minsup, maxgap=maxgap,
                                 maxwindow=maxwindow, device=dev, mesh=mesh,
                                 stats_out=stats, checkpoint=checkpoint,
                                 **part_kw, **kwargs)
    if checkpoint is None and req.task != "stream":
        # repeat cSPADE mines reuse the constrained engine (item store +
        # max-start pool); the cache key folds maxgap/maxwindow — they
        # select different kernels AND different enumerations
        from spark_fsm_tpu_torch.service.devcache import cspade_engine_cache
        return cspade_engine_cache.mine(db, minsup, maxgap=maxgap,
                                        maxwindow=maxwindow, device=dev,
                                        mesh=mesh, stats_out=stats,
                                        **kwargs)
    return mine_cspade_torch(db, minsup, maxgap=maxgap, maxwindow=maxwindow,
                             device=dev, mesh=mesh, stats_out=stats,
                             checkpoint=checkpoint, **kwargs)


def _spam_constraints_check(req: ServiceRequest) -> None:
    maxgap, maxwindow = _constraints(req)
    if maxgap is not None or maxwindow is not None:
        raise ValueError(
            "the SPAM engine serves unconstrained patterns only "
            "(maxgap/maxwindow unsupported — use SPADE_TPU, or "
            "algorithm=AUTO to let the planner route)")


def _spam_cpu(req: ServiceRequest, db: SequenceDB,
              stats: Optional[dict] = None, checkpoint=None) -> Results:
    from spark_fsm_tpu_torch.models.spam_bitmap import mine_spam_cpu

    _spam_constraints_check(req)
    _checkpoint_unsupported(checkpoint, "SPAM", stats)
    minsup = _minsup(req, db)
    return mine_spam_cpu(db, minsup, stats_out=stats)


def _spam_tpu(req: ServiceRequest, db: SequenceDB,
              stats: Optional[dict] = None, checkpoint=None) -> Results:
    from spark_fsm_tpu_torch.models.spam_bitmap import mine_spam_torch

    _spam_constraints_check(req)
    minsup = _minsup(req, db)
    kwargs = config.engine_kwargs("pool_bytes", "node_batch",
                                  "pipeline_depth")
    if req.task == "stream":  # see _spade_tpu: bucket drifting windows
        kwargs["shape_buckets"] = True
        part_kw = {}
    else:
        part_kw = _partition_kwargs()
    return mine_spam_torch(db, minsup, device=service_device(),
                           mesh=config.get_mesh(), stats_out=stats,
                           checkpoint=checkpoint, **part_kw, **kwargs)


def _auto(req: ServiceRequest, db: SequenceDB,
          stats: Optional[dict] = None, checkpoint=None) -> Results:
    from spark_fsm_tpu_torch.service import planner

    return planner.extract_auto(req, db, stats, checkpoint=checkpoint)


def _tsr_params(req: ServiceRequest):
    k = int(req.param("k", "100"))
    minconf = float(req.param("minconf", "0.5"))
    max_side = req.param("max_side")
    return k, minconf, int(max_side) if max_side else None


def _tsr_kwargs() -> dict:
    # TSR's batch width is a separate boot knob from SPADE's (tsr_chunk):
    # SPADE's is a fixed dispatch width, TSR's defaults to an HBM-budget-
    # adaptive size — they must not be tuned together.
    kwargs = config.engine_kwargs("item_cap")
    tsr_chunk = config.engine_kwargs("tsr_chunk").get("tsr_chunk")
    if tsr_chunk is not None:
        kwargs["chunk"] = tsr_chunk
    return kwargs


def _tsr_cpu(req: ServiceRequest, db: SequenceDB,
             stats: Optional[dict] = None, checkpoint=None) -> Results:
    from spark_fsm_tpu_torch.models.tsr import mine_tsr_cpu

    k, minconf, max_side = _tsr_params(req)
    return mine_tsr_cpu(db, k, minconf, max_side=max_side, stats_out=stats,
                        checkpoint=checkpoint, **_tsr_kwargs())


def _tsr_tpu(req: ServiceRequest, db: SequenceDB,
             stats: Optional[dict] = None, checkpoint=None) -> Results:
    from spark_fsm_tpu_torch.models.tsr import mine_tsr_torch

    k, minconf, max_side = _tsr_params(req)
    kwargs = _tsr_kwargs()
    # use_pallas (the reference's spelling, kept): "auto" (default: the
    # kernel on the card) / truthy (force the kernel's branch — its plain
    # version on CPU tensors) / falsy (pin the plain torch evaluator);
    # the port's engine knob is use_kernel
    up = (req.param("use_pallas") or "").lower()
    if up and up != "auto":
        kwargs["use_kernel"] = up not in ("0", "false", "no", "off")
    # resident: "auto" (default, the planner's launch-bound heuristic) /
    # "always" (pin the resident-frontier route where structurally
    # eligible — chaos drills and benches) / "never" (pin the classic
    # host loop).  Folded into the devcache key via kwargs like every
    # other engine knob.
    rp = (req.param("resident") or "").lower()
    if rp and rp != "auto":
        kwargs["resident"] = ("always" if rp in ("always", "1", "true",
                                                 "yes", "on")
                              else "never")
    if req.task == "stream":  # see _spade_tpu: bucket drifting windows
        kwargs["shape_buckets"] = True
    dev = service_device()
    part_kw = _partition_kwargs()
    if part_kw and req.task != "stream":
        # the partitioned orchestrator builds one engine per submesh
        # row — bypass the single-engine devcache (same reasoning as
        # the SPADE route above)
        return mine_tsr_torch(db, k, minconf, max_side=max_side,
                              device=dev, mesh=config.get_mesh(),
                              stats_out=stats, checkpoint=checkpoint,
                              **part_kw, **kwargs)
    if checkpoint is None and req.task != "stream":
        # repeat TSR mines over identical data reuse the built engine
        # (vertical build + token indexing are the fixed ~7s cost of the
        # framework's longest jobs); checkpointed jobs stay uncached
        # (resume binds its own fingerprint) and stream windows change
        # every push (see _spade_tpu's identical reasoning)
        from spark_fsm_tpu_torch.service.devcache import tsr_engine_cache
        return tsr_engine_cache.mine(db, k, minconf, max_side=max_side,
                                     device=dev, mesh=config.get_mesh(),
                                     stats_out=stats, **kwargs)
    return mine_tsr_torch(db, k, minconf, max_side=max_side, device=dev,
                          mesh=config.get_mesh(), stats_out=stats,
                          checkpoint=checkpoint, **kwargs)


def _mesh_bound(fn: Callable[..., Results]) -> Callable[..., Results]:
    """A device plugin's extract as a mesh call (``service/meshcall.py``):
    on a world of ranks every rank mines the leader's request."""
    @functools.wraps(fn)
    def extract(req: ServiceRequest, db: SequenceDB,
                stats: Optional[dict] = None, checkpoint=None) -> Results:
        return meshcall.extract(fn, req, db, stats, checkpoint)

    return extract


ALGORITHMS: Dict[str, AlgorithmPlugin] = {
    "SPADE": AlgorithmPlugin("SPADE", "patterns", _spade_cpu),
    "SPADE_TPU": AlgorithmPlugin("SPADE_TPU", "patterns",
                                 _mesh_bound(_spade_tpu)),
    "SPAM": AlgorithmPlugin("SPAM", "patterns", _spam_cpu),
    "SPAM_TPU": AlgorithmPlugin("SPAM_TPU", "patterns",
                                _mesh_bound(_spam_tpu)),
    "TSR": AlgorithmPlugin("TSR", "rules", _tsr_cpu),
    "TSR_TPU": AlgorithmPlugin("TSR_TPU", "rules", _mesh_bound(_tsr_tpu)),
    # AUTO's registry entry exists so listings ("/admin/algorithms",
    # the 400 body) include it; get_plugin builds the per-request
    # plugin below because AUTO's result KIND depends on the params
    "AUTO": AlgorithmPlugin("AUTO", "patterns", _auto),
}

# the result-identity FAMILY behind each engine name: engines inside a
# family are byte-identical by the parity contract, so the result-reuse
# tier keys cache entries/coalescing on the family — a request hits
# regardless of which engine route produced the entry (earlier work
# composition invariant).  Family names are the historical device-
# engine names so pre-existing cache keys stay valid.
FAMILIES: Dict[str, str] = {
    "SPADE": "SPADE_TPU", "SPADE_TPU": "SPADE_TPU",
    "SPAM": "SPADE_TPU", "SPAM_TPU": "SPADE_TPU",
    "TSR": "TSR_TPU", "TSR_TPU": "TSR_TPU",
}


def get_plugin(req: ServiceRequest) -> AlgorithmPlugin:
    name = (req.param("algorithm") or "SPADE_TPU").upper()
    if name == "AUTO":
        from spark_fsm_tpu_torch.service import planner

        return AlgorithmPlugin("AUTO", planner.infer_kind(req), _auto)
    if name not in ALGORITHMS:
        raise UnknownAlgorithm(name, ALGORITHMS)
    return ALGORITHMS[name]


def effective_params(req: ServiceRequest,
                     n_sequences: Optional[int] = None) -> dict:
    """The request's RESULT-AFFECTING parameters, normalized — the one
    vocabulary the result-reuse tier (service/resultcache.py) keys
    coalescing identity and dominance predicates on.  Two requests with
    equal dicts here (and equal dataset fingerprints) provably mine the
    same result set; engine-routing knobs (fused/resident/use_pallas),
    supervision knobs (retries/deadline_s/priority/checkpoint) and the
    uid are deliberately EXCLUDED — they change scheduling, never
    output (the engines' parity contract).

    ``algo`` is the result-identity FAMILY (``FAMILIES``), not the
    routed engine: SPADE/SPADE_TPU/SPAM/SPAM_TPU (and patterns-AUTO)
    all normalize to one key because their outputs are byte-identical
    by the parity contract — a cache entry produced under one engine
    route serves every other route for the same dataset + params
.  Engine choice is scheduling, never output, exactly
    like the fused/resident knobs already excluded below.

    Pattern algorithms: ``support`` as given (float), plus
    ``minsup_abs`` resolved to the absolute count when the value is
    already absolute (>= 1) or ``n_sequences`` is known — the
    comparable form dominance needs.  Rule algorithms: ``k``,
    ``minconf`` (float; compared exactly via Fraction at serve time),
    ``max_side``.  Raises ValueError on malformed params, same as the
    plugins themselves would.
    """
    plugin = get_plugin(req)
    family = FAMILIES.get(
        plugin.name,
        "TSR_TPU" if plugin.kind == "rules" else "SPADE_TPU")
    if plugin.kind == "rules":
        k, minconf, max_side = _tsr_params(req)
        if k < 1:
            raise ValueError(f"k must be >= 1 (got {k})")
        return {"algo": family, "kind": plugin.kind, "k": k,
                "minconf": minconf, "max_side": max_side}
    support = req.param("support")
    if support is None:
        raise ValueError("train request needs a 'support' parameter")
    rel = float(support)
    minsup_abs: Optional[int] = None
    if rel >= 1.0:
        minsup_abs = int(rel)
    elif n_sequences is not None:
        minsup_abs = abs_minsup(rel, n_sequences)
    maxgap, maxwindow = _constraints(req)
    if plugin.name in ("SPAM", "SPAM_TPU"):
        _spam_constraints_check(req)  # same error as the plugin would raise
    return {"algo": family, "kind": plugin.kind, "support": rel,
            "minsup_abs": minsup_abs, "maxgap": maxgap,
            "maxwindow": maxwindow}
