"""Boot prewarm: pay every enumerable first-use cost before the service
listens — port of ``spark_fsm_tpu/service/prewarm.py``.

The shape-key registry (``utils/shapes.py``) lists the finite set of
device geometries a declared workload envelope will touch.  This module
walks that set and, for every entry, runs the port's own engine on the
card over a tiny synthetic store with the DECLARED global geometry
(``build_vertical``'s ``pad_sequences_to``/``word_multiple`` stretch a
KB-scale token table to the full padded shape): one single-itemset
sequence per item, so every item is a frequent root and one full wave
runs, but no two items co-occur and no child is frequent.  On a CUDA card
nothing compiles per shape; what a first live mine would otherwise pay
is the kernels' ``nvcc`` build (only when the build directory holds no
library for the source), the libraries' loads, each kernel's first
launch and the caching allocator's first reservation of the engine's
pool at full size.  Each warm pays those at the key's geometry and
records the key.  The TSR ladders launch B2 at every (km, width) the
packer can emit, the fused ones over a fused store laid out as the
broker builds it (``service/fusion._fuse_preps``).

The reference's ``_warm_support_concat`` warms XLA programs that
concatenate per-chunk outputs at pow2 arities; torch has no such
program, so it has no counterpart (it is no shape key, so the enumerated
set is the same).  Nor have the reference's direct dispatches of single
programs (the segmented queue variants, the materialize and recompute
chains, the store-build token buckets): here each warm runs the engine's
own mine, which reaches the kernels and allocations those would.

Entry points: :func:`run`, ``POST /admin/prewarm``
(``service/app.py``; parameters override the boot ``[prewarm]``
section) and the boot hook (``[prewarm] enabled = true``).  A key that
fails is a report row with ``error`` and the others go on (the
``prewarm.compile`` fault site exercises that).  ``report["backend"]``
is ``"cuda"`` or ``"cpu"``; ``fresh_compiles``/``compile_s`` count the
kernel builds and first library loads (``utils/jitcache.py``).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from spark_fsm_tpu_torch.device import DeviceLike
from spark_fsm_tpu_torch.utils import faults, obs, shapes
from spark_fsm_tpu_torch.utils.jitcache import (compile_counts,
                                                enable_compile_counter)
from spark_fsm_tpu_torch.utils.obs import log_event

_COMPILE_SECONDS = obs.REGISTRY.histogram(
    "fsm_prewarm_compile_seconds",
    "per-shape-key prewarm wall (service/prewarm.run)")
_COMPILE_ERRORS = obs.REGISTRY.counter(
    "fsm_prewarm_errors_total", "prewarm keys that failed to warm")

_lock = threading.Lock()
_last_report: Optional[dict] = None


def _tiny_vdb(n_sequences: int, n_items: int, n_words: int):
    """Vertical DB with the declared GLOBAL geometry but ~KB content:
    one single-itemset sequence per item (all roots frequent at
    minsup=1, no co-occurrence, so no frequent children), padded out to
    ``n_sequences`` all-zero sequences and ``n_words`` bitmap words."""
    from spark_fsm_tpu_torch.data.vertical import build_vertical

    if n_items < 1 or n_sequences < n_items:
        raise ValueError(
            f"prewarm spec needs 1 <= items <= sequences, got "
            f"items={n_items} sequences={n_sequences}")
    db = [[[i]] for i in range(1, n_items + 1)]
    if n_words > 1:
        # one long sequence forces the declared word count's position
        # range too (word_multiple pads the rest)
        db[0] = [[1]] * (32 * (n_words - 1) + 1)
    return build_vertical(db, min_item_support=1,
                          pad_sequences_to=n_sequences,
                          word_multiple=n_words)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _warm_classic(t: dict, dev, mesh, ekw: dict) -> None:
    from spark_fsm_tpu_torch.models.spade import SpadeTorch

    vdb = _tiny_vdb(t["n_sequences"], t["n_items"], t["n_words"])
    SpadeTorch(vdb, 1, device=dev, mesh=mesh, **ekw).mine()


def _warm_queue(t: dict, dev, mesh) -> None:
    from spark_fsm_tpu_torch.models.spade_queue import QueueSpadeTorch

    vdb = _tiny_vdb(t["n_sequences"], t["n_items"], t["n_words"])
    QueueSpadeTorch(vdb, 1, device=dev, mesh=mesh).mine()
    if t.get("checkpointed"):
        # the segmented (resumable) mine: segments of waves between
        # counter checks, as a checkpointed job runs them
        QueueSpadeTorch(vdb, 1, device=dev, mesh=mesh).mine(
            checkpoint_cb=lambda s: None, checkpoint_every_s=1e9)


def _warm_fused(t: dict, dev, mesh) -> None:
    from spark_fsm_tpu_torch.models.spade_fused import FusedSpadeTorch

    vdb = _tiny_vdb(t["n_sequences"], t["n_items"], t["n_words"])
    FusedSpadeTorch(vdb, 1, device=dev, mesh=mesh).mine()


def _warm_spam(t: dict, dev, mesh, ekw: dict) -> None:
    """The SPAM engine's pure-bitmap wave: ``representation="bitmap"``
    pins the pure plan (the prewarm store's density is ~0, which the
    planner would route entirely to id-lists)."""
    from spark_fsm_tpu_torch.models.spam_bitmap import SpamBitmapTorch

    vdb = _tiny_vdb(t["n_sequences"], t["n_items"], t["n_words"])
    skw = {k: v for k, v in ekw.items()
           if k in ("node_batch", "pipeline_depth", "pool_bytes")}
    SpamBitmapTorch(vdb, 1, device=dev, mesh=mesh, representation="bitmap",
                    **skw).mine()


def _spam_geometry(t: dict, dev, mesh, ekw: dict) -> dict:
    from spark_fsm_tpu_torch.models._common import shard_width
    from spark_fsm_tpu_torch.models.spam_bitmap import spam_geometry

    skw = {k: v for k, v in ekw.items()
           if k in ("node_batch", "pipeline_depth", "pool_bytes")}
    g = spam_geometry(t["n_sequences"], t["n_items"], t["n_words"],
                      device=dev, mesh=mesh, **skw)
    g["row"] = shard_width(g["n_seq"], mesh) * t["n_words"]
    return g


def _warm_spam_hybrid(t: dict, dev, mesh, ekw: dict) -> None:
    """One hybrid-store wave at this dense pad: B3 (B1 and the threshold
    on a mesh) over all-zero rows of the live shapes.  The d0 entry has
    no wave (every item id-list-routed); recording its key keeps
    ``/admin/shapes`` exact."""
    from spark_fsm_tpu_torch.ops import spam_bitops as SB

    g = _spam_geometry(t, dev, mesh, ekw)
    nd, nw, nb = int(t["nd_pad"]), int(t["n_words"]), g["node_batch"]
    if nd:
        pt = torch.zeros(2 * nb, g["row"], dtype=torch.int32, device=dev)
        items = torch.zeros(nd, g["row"], dtype=torch.int32, device=dev)
        if mesh is None:
            SB.wave_extend_prune(pt, items, 1,
                                 torch.zeros(2 * nb, dtype=torch.bool),
                                 n_words=nw, nd_pad=nd)
        else:
            SB.wave_prune_sharded(pt, items, 1, n_words=nw, nd_pad=nd,
                                  mesh=mesh)
        _sync(dev)
    shapes.record(shapes.key_spam_hybrid(g["key_seq"], nw, g["key_rows"],
                                         nb, g["ni_pad"], nd))


def _warm_spam_pair(t: dict, dev, mesh, ekw: dict) -> None:
    """One sparse pair-launch width over all-zero rows with all-pad (-1)
    items."""
    from spark_fsm_tpu_torch.ops import spam_bitops as SB

    g = _spam_geometry(t, dev, mesh, ekw)
    nw, w, nb = int(t["n_words"]), int(t["width"]), g["node_batch"]
    pt = torch.zeros(2 * nb, g["row"], dtype=torch.int32, device=dev)
    store = torch.zeros(g["ni_pad"] + 1, g["row"], dtype=torch.int32,
                        device=dev)
    SB.pair_prune(pt, store, torch.zeros(w, dtype=torch.int64, device=dev),
                  torch.full((w,), -1, dtype=torch.int64, device=dev), 1,
                  torch.zeros(w, dtype=torch.bool, device=dev), nw, mesh)
    _sync(dev)
    shapes.record(shapes.key_spam_pair(g["key_seq"], nw, w))


def _warm_cspade(t: dict, dev, mesh, ekw: dict) -> None:
    from spark_fsm_tpu_torch.models.spade_constrained import (
        ConstrainedSpadeTorch)

    vdb = _tiny_vdb(t["n_sequences"], t["n_items"], t["n_words"])
    ConstrainedSpadeTorch(vdb, 1, maxgap=t["maxgap"],
                          maxwindow=t["maxwindow"], device=dev, mesh=mesh,
                          **ekw).mine()


def _round_prep(eng):
    """The first deepening round's prep pair on ``eng`` (chunk set as the
    round sets it)."""
    m = min(eng.item_cap, eng.vdb.n_items)
    eng.chunk = eng._round_chunk(m)
    return m, eng._prep(m)


def _walk_eval_ladder(eng, superbatch, p1=None, s1=None, m_pad=None):
    """Launch the engine's evaluator (B2 on the card) once per (km,
    width) of the ladder, every lane a -1 slot (the all-ones row), and
    record each launch's key: ``tsr-eval`` over the engine's own prep,
    ``tsr-fused`` over a fused store of ``m_pad`` rows."""
    from spark_fsm_tpu_torch.ops import ragged_batch as RB

    for km, width in superbatch:
        launch = RB.Launch(km, width, [], [])
        xy = eng._stager.take(launch, [])
        eng._eval_fn(km)(p1, s1, eng._put(xy))
        if m_pad is None:
            eng._count_launch(launch)
        else:
            shapes.record(shapes.key_tsr_fused(eng.n_seq, eng.n_words,
                                               m_pad, km, width))
    _sync(eng.device)


def _warm_tsr(t: dict, dev, mesh) -> None:
    """A tiny TSR mine, then the eval ladder at the first deepening
    round's store, then the fused ladder: for each enumerated ``m_pad``
    a fused store laid out as the broker lays one out (this round's rows,
    zero rows up to ``m_pad``, the all-ones row)."""
    from spark_fsm_tpu_torch.models.tsr import TsrTorch
    from spark_fsm_tpu_torch.service import fusion

    vdb = _tiny_vdb(t["n_sequences"], t["n_items"], t["n_words"])
    eng = TsrTorch(vdb, min(8, t["n_items"]), 0.5, max_side=2, device=dev,
                   mesh=mesh)
    eng.mine()
    m, (p1, s1) = _round_prep(eng)
    ladder = t.get("superbatch", ())
    _walk_eval_ladder(eng, ladder, p1, s1)
    for m_pad in t.get("fused_m", ()):
        pf, sf = fusion._fuse_preps([(p1, s1)], m_pad, m)
        _walk_eval_ladder(eng, ladder, pf, sf, m_pad=m_pad)
        del pf, sf


def _warm_tsr_part(t: dict, dev, mesh) -> None:
    """A tiny partitioned mine (kept out of the ``fsm_partition_*``
    families), then every part engine walks the eval ladder at the inner
    geometry."""
    from spark_fsm_tpu_torch.models.tsr import TsrPartitioned

    vdb = _tiny_vdb(t["n_sequences"], t["n_items"], t["n_words"])
    orch = TsrPartitioned(vdb, min(8, t["n_items"]), 0.5, device=dev,
                          mesh=mesh, parts=t["parts"], max_side=2,
                          record_metrics=False)
    orch.mine()
    for eng in orch.engines.values():
        _, (p1, s1) = _round_prep(eng)
        _walk_eval_ladder(eng, t.get("superbatch", ()), p1, s1)


def _warm_resident(t: dict, dev, mesh) -> None:
    """One resident wave at this key's width over an empty frontier: the
    carry at the round's caps, zero prep stores of the round's ``m`` rows
    (plus the all-ones row), B2 over the popped (inactive) lanes."""
    from spark_fsm_tpu_torch.models._common import device_hbm_budget
    from spark_fsm_tpu_torch.models.tsr import tsr_geometry
    from spark_fsm_tpu_torch.ops import resident_frontier as RF
    from spark_fsm_tpu_torch.ops import rule_support as RS

    nw, m, nb = int(t["n_words"]), int(t["m"]), int(t["nb"])
    n_seq = tsr_geometry(t["n_sequences"], n_words=nw)["n_seq"]
    caps = RF.caps_for(n_seq, nw, m, device_hbm_budget(dev))
    if caps is None or (caps.ring, caps.km) != (t["ring"], t["km"]):
        raise ValueError(f"resident caps on {dev} differ from the "
                         f"enumeration's: {caps}")
    carry = RF.carry_from_state(RF.pack_state([], [], caps), 1, dev)
    store = torch.zeros(m + 1, n_seq * nw, dtype=torch.int32, device=dev)
    store[m] = -1
    evaluate = RS.rule_supports if dev.type == "cuda" else RS.rule_supports_plain
    RF.wave(carry, store, store, torch.zeros(m, dtype=torch.int32,
                                             device=dev),
            1, 2, 1, 1 << 30, nb, nw, evaluate)
    _sync(dev)
    shapes.record(shapes.key_tsr_resident(n_seq, nw, m, caps.km, nb,
                                          caps.ring))


def _warm_sweep(t: dict, dev, mesh) -> None:
    """Two pushes through an incremental miner at the declared seq floor
    (the token scatter for a fresh tree, then the sweep over an existing
    one), the batch store rebuilt at this key's row bucket, then one B1
    sweep launch over it."""
    from spark_fsm_tpu_torch.models._common import prep_rows, to_index
    from spark_fsm_tpu_torch.ops import pair_support as PS
    from spark_fsm_tpu_torch.streaming.incremental import (
        IncrementalWindowMiner)

    miner = IncrementalWindowMiner(
        1.0, max_batches=4, device=dev, mesh=mesh,
        # live batch stores bucket at bucket_seq(max(push, floor)): the
        # floor carries both envelope knobs to land on the live bucket
        seq_floor=max(t["batch_sequences"], t.get("seq_floor", 0)))
    batch = [[[i]] for i in range(1, t["n_items"] + 1)]
    if t["n_words"] > 1:
        batch[0] = [[1]] * (32 * (t["n_words"] - 1) + 1)
    miner.push(batch)
    miner.push(list(batch))
    st = next(iter(miner._states.values()))
    f1 = sorted(miner._item_totals)
    target = t["n_rows"]
    if st._n_rows != target or st.store is None:
        st.drop_store()
        st._project(f1, max(0, target - st.ni_rows - 1))
    if st._n_rows != target:
        raise ValueError(f"sweep store has {st._n_rows} rows, the key "
                         f"{target}")
    scratch = st._n_rows - 1
    pt = prep_rows(st.store, [scratch] * 8, st.s_local, st.n_words)
    z = to_index(np.zeros(8, np.int64), dev)
    if miner.use_kernel:
        PS.batch_supports(pt, st.store, st.ni_rows, z, z, n_words=st.n_words,
                          n_live=st.n_present)
    _sync(dev)


def _warm_predict(t: dict, dev) -> None:
    """One rung of the /predict scoring ladder (``rule_trie`` scores zero
    planes at the exact (F, D, W, M) a live wave would)."""
    from spark_fsm_tpu_torch.ops import rule_trie

    rule_trie.warm_geometry(int(t["lanes"]), int(t["depth"]),
                            int(t["wave"]), int(t["topm"]), device=dev)


def run(spec: shapes.WorkloadSpec, *, mesh=None,
        engine_kwargs: Optional[dict] = None,
        device: DeviceLike = None) -> dict:
    """Walk the enumerated shape set on ``device`` (None = CUDA) and warm
    every entry; returns a report with per-key walls and build/load
    counts and keeps it for ``/admin/stats`` and ``/admin/shapes``."""
    from spark_fsm_tpu_torch.models._common import engine_device

    enable_compile_counter()
    dev = engine_device(device, mesh)
    engine_kwargs = dict(engine_kwargs or {})
    eng_sub = {k: v for k, v in engine_kwargs.items()
               if k in ("chunk", "node_batch", "pipeline_depth",
                        "recompute_chunk", "pool_bytes")}
    targets = shapes.enumerate_shapes(spec, mesh=mesh,
                                      engine_kwargs=engine_kwargs,
                                      device=dev)
    rows: List[dict] = []
    t_all = time.monotonic()
    # prewarm owns a trace of its own (uid "prewarm"), one span per key
    with obs.trace("prewarm", site="prewarm", keys=len(targets)):
        rows.extend(_run_keys(targets, dev, mesh, eng_sub))
    report = {
        "keys": rows,
        "enumerated": sorted(targets),
        "total_wall_s": round(time.monotonic() - t_all, 3),
        "backend": dev.type,
        "ts": round(time.time(), 3),
    }
    global _last_report
    with _lock:
        _last_report = report
    log_event("prewarm_done", keys=len(rows),
              total_wall_s=report["total_wall_s"])
    return report


def _run_keys(targets, dev, mesh, eng_sub) -> List[dict]:
    warms = {
        "classic": lambda t: _warm_classic(t, dev, mesh, eng_sub),
        "queue": lambda t: _warm_queue(t, dev, mesh),
        "fused": lambda t: _warm_fused(t, dev, mesh),
        "cspade": lambda t: _warm_cspade(t, dev, mesh, eng_sub),
        "spam": lambda t: _warm_spam(t, dev, mesh, eng_sub),
        "spam_hybrid": lambda t: _warm_spam_hybrid(t, dev, mesh, eng_sub),
        "spam_pair": lambda t: _warm_spam_pair(t, dev, mesh, eng_sub),
        "tsr": lambda t: _warm_tsr(t, dev, mesh),
        "tsr_part": lambda t: _warm_tsr_part(t, dev, mesh),
        "tsr_resident": lambda t: _warm_resident(t, dev, mesh),
        "sweep": lambda t: _warm_sweep(t, dev, mesh),
        "predict": lambda t: _warm_predict(t, dev),
    }
    rows: List[dict] = []
    for key, t in sorted(targets.items()):
        c0 = compile_counts()
        t0 = time.monotonic()
        err = None
        with obs.span("prewarm.compile", shape_key=key, kind=t["kind"]):
            try:
                # chaos seam: an injected failure here proves the per-key
                # isolation below (one bad key must not take down boot or
                # the other keys' warms)
                faults.fault_site("prewarm.compile", shape_key=key,
                                  kind=t["kind"])
                # tsr_eval / tsr_fused / tsr_inner keys are warmed by the
                # "tsr" / "tsr_part" entries' ladder walks; the separate
                # key lets /admin/shapes drift name the exact launch
                warm = warms.get(t["kind"])
                if warm is not None:
                    warm(t)
            except Exception as exc:  # a failed warm must not take down
                err = f"{type(exc).__name__}: {exc}"  # boot
                _COMPILE_ERRORS.inc()
        _COMPILE_SECONDS.observe(time.monotonic() - t0, kind=t["kind"])
        c1 = compile_counts()
        row = {"shape_key": key, "kind": t["kind"],
               "wall_s": round(time.monotonic() - t0, 3),
               "fresh_compiles": c1["count"] - c0["count"],
               "compile_s": round(c1["seconds"] - c0["seconds"], 3)}
        if err:
            row["error"] = err
        rows.append(row)
        log_event("prewarm_key", **row)
    return rows


def last_report() -> Optional[dict]:
    with _lock:
        return _last_report


def spec_from_config(pc) -> Optional[shapes.WorkloadSpec]:
    """WorkloadSpec from a config.PrewarmConfig; None when the envelope
    is empty (nothing to warm)."""
    constraints = ()
    if pc.maxgap is not None or pc.maxwindow is not None:
        constraints = ((pc.maxgap, pc.maxwindow),)
    if pc.sequences <= 0 and pc.stream_batch_sequences <= 0:
        return None
    return shapes.WorkloadSpec(
        n_sequences=int(pc.sequences), n_items=int(pc.items),
        n_words=max(1, int(pc.words)), constraints=constraints,
        tsr=bool(pc.tsr),
        fusion_jobs=_fusion_jobs_default(),
        partition_parts=_partition_parts_default(),
        stream_batch_sequences=int(pc.stream_batch_sequences),
        stream_items=int(pc.stream_items),
        stream_seq_floor=int(pc.stream_seq_floor),
        checkpointed=bool(pc.checkpointed),
        **_predict_defaults())


def _predict_defaults() -> Dict[str, int]:
    """The /predict scoring-ladder envelope the boot config implies (0s
    when the plane is off or its floors are per-artifact)."""
    from spark_fsm_tpu_torch import config

    pc = config.get_config().predict
    if not pc.enabled or pc.lanes_floor <= 0 or pc.depth_floor <= 0:
        return {"predict_lanes": 0, "predict_depth": 0,
                "predict_wave": 0, "predict_topm": 0}
    return {"predict_lanes": int(pc.lanes_floor),
            "predict_depth": int(pc.depth_floor),
            "predict_wave": max(1, int(pc.max_wave)),
            "predict_topm": max(1, int(pc.topm))}


def _partition_parts_default() -> int:
    """The partitioned-ladder envelope the boot config implies (the
    request router's own resolver, so warmed and served layouts agree)."""
    from spark_fsm_tpu_torch.service.plugins import resolved_partition_parts

    return resolved_partition_parts()


def _fusion_jobs_default() -> int:
    """The fused-ladder envelope the boot config implies: groups up to
    ``[fusion] max_jobs`` when the broker is on."""
    from spark_fsm_tpu_torch import config

    fc = config.get_config().fusion
    return int(fc.max_jobs) if fc.enabled else 0


def spec_from_params(params: Dict[str, str], pc) -> shapes.WorkloadSpec:
    """WorkloadSpec for ``POST /admin/prewarm``: request parameters
    override the boot ``[prewarm]`` envelope field by field."""
    def geti(name, default):
        v = params.get(name)
        return int(v) if v not in (None, "") else int(default or 0)

    maxgap = params.get("maxgap", pc.maxgap)
    maxwindow = params.get("maxwindow", pc.maxwindow)
    constraints = ()
    if maxgap not in (None, "") or maxwindow not in (None, ""):
        constraints = ((int(maxgap) if maxgap not in (None, "") else None,
                        int(maxwindow) if maxwindow not in (None, "")
                        else None),)
    truthy = lambda v, d: (str(v).lower() not in ("", "0", "false", "no",  # noqa: E731
                                                  "off")
                           if v is not None else bool(d))
    return shapes.WorkloadSpec(
        n_sequences=geti("sequences", pc.sequences),
        n_items=geti("items", pc.items),
        n_words=max(1, geti("words", pc.words)),
        constraints=constraints,
        tsr=truthy(params.get("tsr"), pc.tsr),
        fusion_jobs=geti("fusion_jobs", _fusion_jobs_default()),
        partition_parts=geti("partition_parts",
                             _partition_parts_default()),
        stream_batch_sequences=geti("stream_batch_sequences",
                                    pc.stream_batch_sequences),
        stream_items=geti("stream_items", pc.stream_items),
        stream_seq_floor=geti("stream_seq_floor", pc.stream_seq_floor),
        checkpointed=truthy(params.get("checkpointed"), pc.checkpointed),
        **{name: geti(name, default)
           for name, default in _predict_defaults().items()})
