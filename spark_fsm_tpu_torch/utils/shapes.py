"""Shape-key registry: compiled device geometry, enumerable and observed.

Every engine stamps its job stats with a ``shape_key`` — a string that
identifies the COMPILED geometry of its device programs (two mines with
equal keys reuse every compiled program).  Until now each engine built
that string inline, which made the set of keys a runtime observation
only: an operator could count distinct keys after the fact, but nothing
could say, for a given config, which keys a deployment WILL compile —
so a fresh deployment learned its cold-start bill (41.7 s per
cache-missed geometry, BASELINE.json ``cold_start``) by paying it on a
live ``/train``.

This module closes that loop:

- **one definition per key format** (``key_*``): the engines call these
  when stamping stats, so the enumerator and the engines cannot drift
  on spelling;
- **a runtime registry** (:func:`record` / :func:`recorded`): engines
  record their key at construction time — the moment that decides which
  programs compile — so ``/admin/shapes`` can diff what actually ran
  against what was enumerated (:func:`drift`);
- **an enumerator** (:func:`enumerate_shapes`): given a
  :class:`WorkloadSpec` (the data geometry an operator expects) and the
  boot engine knobs, compute the finite set of shape keys the
  service-default paths will compile — WITHOUT mining — by calling the
  same geometry functions the engines' constructors use
  (``classic_geometry`` et al.).  ``service/prewarm.py`` walks this set
  at boot and compiles every entry against tiny synthetic stores.

Key formats (the geometry axes that decide compiled shapes):

  ``classic:s{S}w{W}r{R}nb{NB}c{C}``        models/spade_tpu.py
  ``queue:s{S}w{W}ni{NI}nb{NB}r{RING}``     models/spade_queue.py
  ``fused:s{S}w{W}ni{NI}f{FCAP}``           models/spade_fused.py
  ``cspade:s{S}w{W}i{I}p{P}nb{NB}c{C}g{G}x{X}d{BITS}``
                                            models/spade_constrained.py
                                            (g/x: maxgap/maxwindow — they
                                            select DIFFERENT compiled
                                            kernels; d: state dtype bits)
  ``tsr:s{S}w{W}``                          models/tsr.py (static part;
                                            per-round top-m varies by
                                            design)
  ``tsr-eval:s{S}w{W}km{K}c{C}``            models/tsr.py eval launches —
                                            one per super-batch geometry
                                            (km bucket x pow2 width, the
                                            ops/ragged_batch.py ladder);
                                            recorded per launch at
                                            dispatch time
  ``tsr-fused:s{S}w{W}m{M}km{K}c{C}``       service/fusion.py cross-job
                                            fused eval launches — item
                                            axis = concat of the fused
                                            jobs' prep stores padded to
                                            the pow2 bucket M
  ``tsr-resident:s{S}w{W}m{M}km{K}nb{NB}r{RING}``
                                            ops/resident_frontier.py
                                            whole-ladder resident
                                            program — one key per wave
                                            width (wide + late-wave
                                            narrow), ring/record caps
                                            derived from the eval
                                            budget by caps_for
  ``sweep:s{S}w{W}r{R}i{NI}``               streaming/incremental.py
                                            batch-store geometry (the
                                            config-5 mid-stream compile)
  ``predict:f{F}d{D}w{W}m{M}``              ops/rule_trie.py batched
                                            prefix->consequent scoring —
                                            F pow2 rule-lane axis, D pow2
                                            antecedent/prefix token
                                            depth, W wave width (fused
                                            request rows), M top-m pad;
                                            recorded per launch by
                                            score_wave
  ``tsr-part:p{P}s{S}w{W}``                 models/tsr.py TsrPartitioned
                                            (parallel/partition.py): the
                                            2-D parts x seq arrangement —
                                            S is the INNER (per-row)
                                            padded seq axis; the per-part
                                            engines additionally record
                                            the inner ``tsr:*`` /
                                            ``tsr-eval:*`` keys, which
                                            the enumerator lists at the
                                            inner geometry

Port of ``spark_fsm_tpu/utils/shapes.py``.  On a CUDA card nothing
compiles per shape: a key names the geometry an engine sizes its device
buffers and launches at, spelled as the reference's XLA path spells it
(its sequence axis, before the port pads to B1's 32-sequence tile:
``models/_common.key_seq``), so both packages give equal keys for equal
input and options.  The reference's ``use_pallas`` moves its geometry
(Pallas sequence blocks); the port's kernels take any sequence count, so
:func:`enumerate_shapes` lists the same set on either device, and the
enumeration is the reference's without Pallas.  The one difference: the
``tsr-fused`` ladder is listed on either device, because the port's
fused waves launch B2 on the card where the reference's broker admits
only its jnp path.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Iterable, List, Optional, Tuple

# ----------------------------------------------------------------- formats


def key_classic(n_seq: int, n_words: int, rows: int, node_batch: int,
                chunk: int) -> str:
    return f"classic:s{n_seq}w{n_words}r{rows}nb{node_batch}c{chunk}"


def key_queue(n_seq: int, n_words: int, ni_pad: int, nb: int,
              ring: int) -> str:
    return f"queue:s{n_seq}w{n_words}ni{ni_pad}nb{nb}r{ring}"


def key_fused(n_seq: int, n_words: int, ni_pad: int, f_cap: int) -> str:
    return f"fused:s{n_seq}w{n_words}ni{ni_pad}f{f_cap}"


def key_cspade(n_seq: int, n_words: int, item_rows: int, pool_slots: int,
               node_batch: int, chunk: int, maxgap: Optional[int],
               maxwindow: Optional[int], state_bits: int) -> str:
    g = "n" if maxgap is None else int(maxgap)
    x = "n" if maxwindow is None else int(maxwindow)
    return (f"cspade:s{n_seq}w{n_words}i{item_rows}p{pool_slots}"
            f"nb{node_batch}c{chunk}g{g}x{x}d{state_bits}")


def key_tsr(n_seq: int, n_words: int) -> str:
    return f"tsr:s{n_seq}w{n_words}"


def key_tsr_eval(n_seq: int, n_words: int, km: int, width: int) -> str:
    """One TSR eval-launch geometry: the (km side bucket, pow2 candidate
    width) super-batch the ragged packer emitted (ops/ragged_batch.py).
    The engine records one per launch; the enumerator lists the full
    ladder so prewarm can compile every launch program a live mine can
    dispatch."""
    return f"tsr-eval:s{n_seq}w{n_words}km{km}c{width}"


def key_tsr_fused(n_seq: int, n_words: int, m_pad: int, km: int,
                  width: int) -> str:
    """One CROSS-JOB fused eval-launch geometry (service/fusion.py):
    the broker concatenates the participating jobs' prep stores along
    the item axis and pads it to the pow2 bucket ``m_pad``, so the
    fused launch program compiles per (m bucket, km, width) — a finite
    ladder the enumerator lists (``fusion_jobs`` on the WorkloadSpec)
    and prewarm walks, keeping the zero-fresh-compile guarantee across
    fusion."""
    return f"tsr-fused:s{n_seq}w{n_words}m{m_pad}km{km}c{width}"


def key_tsr_resident(n_seq: int, n_words: int, m: int, km: int, nb: int,
                     ring: int) -> str:
    """One resident-frontier program geometry (ops/resident_frontier.py):
    the whole-km-ladder ``lax.while_loop`` compiled per (prep item rows
    m, km-ladder depth, wave width, ring capacity).  The engine records
    the wide key at resident-round start and the narrow key when the
    late-wave switch first compiles it; record/topk caps derive from
    (ring, K_PAD) so they add no axis."""
    return f"tsr-resident:s{n_seq}w{n_words}m{m}km{km}nb{nb}r{ring}"


def key_spam(n_seq: int, n_words: int, rows: int, node_batch: int,
             ni_pad: int) -> str:
    """One SPAM wave-engine geometry (models/spam_bitmap.py): the
    fixed-shape all-items support pass compiles per (seq axis, words,
    store rows, node batch, padded item axis) — ONE key per dataset
    geometry because the wave shape is candidate-raggedness-independent
    by construction (that independence is the engine's point)."""
    return f"spam:s{n_seq}w{n_words}r{rows}nb{node_batch}i{ni_pad}"


def key_spam_hybrid(n_seq: int, n_words: int, rows: int, node_batch: int,
                    ni_pad: int, nd_pad: int) -> str:
    """One HYBRID-store SPAM geometry: the planner's density
    crossover routed some items to id-lists, so the fused wave runs over
    a gathered dense block of ``nd_pad`` rows instead of the full item
    axis — a different compiled wave program per dense pad, hence the
    extra ``d`` axis.  Keeps the ``spam:`` prefix (the pure-bitmap plan
    is the ``d``-less spelling, byte-compatible with pre-hybrid keys).
    ``nd_pad`` walks the item tile ladder 0..ni_pad; 0 = every item
    id-list-routed, no wave program at all (pair launches only)."""
    return (f"spam:s{n_seq}w{n_words}r{rows}nb{node_batch}i{ni_pad}"
            f"d{nd_pad}")


def key_spam_pair(n_seq: int, n_words: int, width: int) -> str:
    """One sparse-candidate pair-launch geometry (hybrid SPAM store):
    candidates over id-list-routed items dispatch as explicit
    (parent row, item) pairs at pow2 widths 64..chunk — one compiled
    prune program per width, recorded at dispatch time like the
    ``tsr-eval`` ladder."""
    return f"spam-pair:s{n_seq}w{n_words}c{width}"


def key_predict(lanes: int, depth: int, wave: int, m_pad: int) -> str:
    """One batched rule-trie scoring geometry (ops/rule_trie.py): the
    pow2 rule-lane axis F, the pow2 antecedent/observed-prefix token
    depth D, the wave width W (concurrent request rows fused into one
    launch by service/predictor.py), and the pow2 top-m pad M.  The
    artifact compiler pads live rule sets UP to the declared envelope
    floors so live predicts land on prewarmed keys."""
    return f"predict:f{lanes}d{depth}w{wave}m{m_pad}"


def key_sweep(n_seq: int, n_words: int, n_rows: int, ni_rows: int) -> str:
    return f"sweep:s{n_seq}w{n_words}r{n_rows}i{ni_rows}"


def key_tsr_part(n_parts: int, n_seq_inner: int, n_words: int) -> str:
    """The partitioned-TSR umbrella key (models/tsr.py TsrPartitioned):
    the 2-D ``parts x seq`` arrangement over the inner per-row padded
    sequence axis.  The per-part engines record the inner ``tsr:*`` and
    per-launch ``tsr-eval:*`` keys themselves; this key identifies the
    orchestration geometry so /admin/shapes can see that a partitioned
    ladder was (or was not) enumerated and warmed."""
    return f"tsr-part:p{n_parts}s{n_seq_inner}w{n_words}"


_PARTITION_SKIP = object()  # sentinel: invalid partition override


# ---------------------------------------------------------------- registry

_lock = threading.Lock()
_recorded: Dict[str, int] = {}


def record(key: str) -> None:
    """Note a compiled-geometry key at engine-construction time (the
    moment that fixes which device programs compile)."""
    with _lock:
        _recorded[key] = _recorded.get(key, 0) + 1


def recorded() -> Dict[str, int]:
    """Every shape key observed this process, with construction counts."""
    with _lock:
        return dict(_recorded)


def reset_recorded() -> None:
    with _lock:
        _recorded.clear()


def drift(enumerated: Iterable[str]) -> List[str]:
    """Runtime-observed keys absent from an enumerated set — each one is
    a geometry a prewarmed deployment would still compile on a live
    request (registry drift; surfaced by ``/admin/shapes``)."""
    known = set(enumerated)
    return sorted(k for k in recorded() if k not in known)


# -------------------------------------------------------------- enumerator


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """The data geometry an operator expects to serve — everything the
    enumerator needs to list the shape keys without mining.

    ``n_sequences``/``n_items``/``n_words``: the batch ``/train``
    envelope (sequence count, frequent-projection width at the service
    support, bitmap word count).  ``constraints``: (maxgap, maxwindow)
    pairs cSPADE requests will carry.  ``tsr``: also enumerate the TSR
    engine's geometry.  ``stream_batch_sequences``/``stream_items``: the
    incremental streaming envelope; ``sweep_row_buckets`` successive pow2
    work-row buckets are listed per sweep geometry.  ``checkpointed``:
    prewarm also runs the segmented (resumable) queue mine.
    ``fusion_jobs``: list the ``tsr-fused`` ladder for groups of up to
    this many concurrent TSR jobs (0 = fusion not served).
    ``partition_parts``: >= 2 lists the ``tsr-part`` key and the per-part
    inner ladder.  ``predict_*``: the prediction-serving envelope (lane
    and depth floors, max fused wave, default top-m).  The reference's
    ``max_tokens`` (the token-table bound of its store-build warm) has no
    counterpart: the port builds stores without per-length programs.
    """

    n_sequences: int
    n_items: int
    n_words: int = 1
    constraints: Tuple[Tuple[Optional[int], Optional[int]], ...] = ()
    tsr: bool = False
    fusion_jobs: int = 0
    partition_parts: int = 0
    stream_batch_sequences: int = 0
    stream_items: int = 0
    stream_seq_floor: int = 0  # must mirror [prewarm] stream_seq_floor
    sweep_row_buckets: int = 4
    checkpointed: bool = False
    predict_lanes: int = 0
    predict_depth: int = 0
    predict_wave: int = 0
    predict_topm: int = 0


def enumerate_shapes(spec: WorkloadSpec, *, mesh=None,
                     engine_kwargs: Optional[dict] = None,
                     device=None) -> Dict[str, dict]:
    """The finite set of service-default shape keys for ``spec`` under
    the given boot knobs — a superset of what the router will run (the
    queue engine, its classic fallback and the dense engine are all
    listed).  Returns ``{shape_key: target}``, ``target`` carrying the
    kind and geometry ``service/prewarm.py`` needs.  Calls the geometry
    functions the engines' constructors call, so enumeration cannot drift
    from construction.  ``device`` (None = CUDA) sizes the budgets, as an
    engine on it would."""
    from spark_fsm_tpu_torch.models import spade, spade_constrained
    from spark_fsm_tpu_torch.models import spade_fused, spade_queue
    from spark_fsm_tpu_torch.models import spam_bitmap, tsr
    from spark_fsm_tpu_torch.models._common import (
        I_TILE, device_hbm_budget, engine_device, next_pow2)
    from spark_fsm_tpu_torch.ops import ragged_batch as RB

    ekw = dict(engine_kwargs or {})
    dev = engine_device(device, mesh)
    out: Dict[str, dict] = {}

    def add(key: str, **target) -> None:
        out.setdefault(key, target)

    ns, ni, nw = int(spec.n_sequences), int(spec.n_items), int(spec.n_words)
    if ns > 0 and ni > 0:
        ckw = {k: v for k, v in ekw.items()
               if k in ("chunk", "node_batch", "pipeline_depth",
                        "recompute_chunk", "pool_bytes")}
        g = spade.classic_geometry(ns, ni, nw, device=dev, mesh=mesh, **ckw)
        add(g["shape_key"], kind="classic", n_sequences=ns, n_items=ni,
            n_words=nw)
        q = spade_queue.queue_geometry(ns, ni, nw, device=dev, mesh=mesh)
        add(q["shape_key"], kind="queue", n_sequences=ns, n_items=ni,
            n_words=nw, checkpointed=bool(spec.checkpointed))
        f = spade_fused.fused_geometry(ns, ni, nw, mesh=mesh)
        add(f["shape_key"], kind="fused", n_sequences=ns, n_items=ni,
            n_words=nw)
        # the SPAM wave at the pure geometry, every dense-block pad the
        # density split can produce (the item-tile ladder 0..ni_pad) and
        # the sparse pair-launch pow2 widths
        skw = {k: v for k, v in ekw.items()
               if k in ("node_batch", "pipeline_depth", "pool_bytes")}
        sg = spam_bitmap.spam_geometry(ns, ni, nw, device=dev, mesh=mesh,
                                       **skw)
        add(sg["shape_key"], kind="spam", n_sequences=ns, n_items=ni,
            n_words=nw)
        nd = 0
        while nd <= sg["ni_pad"]:
            add(key_spam_hybrid(sg["key_seq"], nw, sg["key_rows"],
                                sg["node_batch"], sg["ni_pad"], nd),
                kind="spam_hybrid", n_sequences=ns, n_items=ni, n_words=nw,
                nd_pad=nd)
            nd += sg["tile"]
        w = 64
        while w <= sg["chunk"]:
            add(key_spam_pair(sg["key_seq"], nw, w),
                kind="spam_pair", n_sequences=ns, n_items=ni, n_words=nw,
                width=w)
            w *= 2
        for maxgap, maxwindow in spec.constraints:
            cg = spade_constrained.cspade_geometry(
                ns, ni, nw, maxgap=maxgap, maxwindow=maxwindow, device=dev,
                mesh=mesh, **ckw)
            add(cg["shape_key"], kind="cspade", n_sequences=ns, n_items=ni,
                n_words=nw, maxgap=maxgap, maxwindow=maxwindow)
        if spec.tsr:
            tg = tsr.tsr_geometry(ns, mesh=mesh, n_words=nw)
            # the eval-launch ladder the ragged packer can emit: lane floor
            # 32 (the plain path; the kernel path's 128-lane launches are
            # a subset) up to a pinned tsr_chunk, else the dispatch
            # quantum the engine's width resolves to
            tsr_chunk = int(ekw.get("tsr_chunk") or 0)
            hi = tsr_chunk or RB.dispatch_quantum_lanes(tg["n_seq"], nw)
            ladder = RB.superbatch_geometries(32, hi)
            add(tg["shape_key"], kind="tsr", n_sequences=ns, n_items=ni,
                n_words=nw, superbatch=ladder)
            for km, width in ladder:
                add(key_tsr_eval(tg["n_seq"], nw, km, width),
                    kind="tsr_eval", km=km, width=width)
            if mesh is None:
                # the resident route's wave widths for every round of the
                # iterative-deepening ladder whose caps fit the budget
                from spark_fsm_tpu_torch.ops import resident_frontier as RF

                budget = device_hbm_budget(dev)
                m_res = min(int(ekw.get("item_cap")
                                or tsr.ITEM_CAP_DEFAULT), ni)
                while True:
                    caps = RF.caps_for(tg["n_seq"], nw, m_res, budget)
                    if caps is None:
                        break
                    widths = [caps.nb] + ([caps.nb_late]
                                          if caps.nb_late < caps.nb else [])
                    for nb in widths:
                        add(key_tsr_resident(tg["n_seq"], nw, m_res,
                                             caps.km, nb, caps.ring),
                            kind="tsr_resident", n_sequences=ns,
                            n_items=ni, n_words=nw, m=m_res, nb=nb,
                            ring=caps.ring, km=caps.km)
                    if m_res >= ni:
                        break
                    m_res = min(m_res * 2, ni)
            if spec.partition_parts >= 2:
                inner = _inner_row(mesh, spec.partition_parts)
                if inner is not _PARTITION_SKIP:
                    tgp = tsr.tsr_geometry(ns, mesh=inner, n_words=nw)
                    hi_p = tsr_chunk or RB.dispatch_quantum_lanes(
                        tgp["n_seq"], nw)
                    ladder_p = RB.superbatch_geometries(32, hi_p)
                    add(key_tsr_part(spec.partition_parts, tgp["n_seq"],
                                     nw),
                        kind="tsr_part", n_sequences=ns, n_items=ni,
                        n_words=nw, parts=int(spec.partition_parts),
                        superbatch=ladder_p)
                    add(tgp["shape_key"], kind="tsr_inner")
                    for km, width in ladder_p:
                        add(key_tsr_eval(tgp["n_seq"], nw, km, width),
                            kind="tsr_eval", km=km, width=width)
            if spec.fusion_jobs >= 2 and mesh is None:
                # groups of 2..fusion_jobs first-round prep stores
                # concatenated and pow2-padded (service/fusion.py); the
                # (km, width) set is the solo ladder (the broker's caps are
                # minima of the engines')
                m1 = min(tsr.ITEM_CAP_DEFAULT, ni)
                fused_m = sorted({RB.next_pow2(j * m1)
                                  for j in range(2, spec.fusion_jobs + 1)})
                out[tg["shape_key"]]["fused_m"] = fused_m
                for m_pad in fused_m:
                    for km, width in ladder:
                        add(key_tsr_fused(tg["n_seq"], nw, m_pad, km,
                                          width),
                            kind="tsr_fused", m_pad=m_pad, km=km,
                            width=width)

    if spec.stream_batch_sequences > 0 and spec.stream_items > 0:
        from spark_fsm_tpu_torch.streaming import incremental

        swg = incremental.sweep_geometry(
            int(spec.stream_batch_sequences), nw, mesh=mesh,
            seq_floor=int(spec.stream_seq_floor))
        ni_rows = -(-max(int(spec.stream_items), 1) // I_TILE) * I_TILE
        rows = next_pow2(ni_rows + 1)
        for _ in range(max(1, int(spec.sweep_row_buckets))):
            add(key_sweep(swg["n_seq"], swg["n_words"], rows, ni_rows),
                kind="sweep",
                batch_sequences=int(spec.stream_batch_sequences),
                n_items=int(spec.stream_items), n_words=nw,
                seq_floor=int(spec.stream_seq_floor),
                ni_rows=ni_rows, n_rows=rows)
            rows *= 2

    if spec.predict_wave > 0 and spec.predict_lanes > 0:
        # one scoring geometry per pow2 wave bucket at the declared floors
        f_pad = next_pow2(max(int(spec.predict_lanes), 1))
        d_pad = next_pow2(max(int(spec.predict_depth), 1))
        m_pad = next_pow2(max(int(spec.predict_topm), 1))
        w = 1
        w_hi = next_pow2(max(int(spec.predict_wave), 1))
        while w <= w_hi:
            add(key_predict(f_pad, d_pad, w, m_pad),
                kind="predict", lanes=f_pad, depth=d_pad, wave=w,
                topm=m_pad)
            w *= 2
    return out


def _inner_row(mesh, parts: int):
    """The inner (per-row) mesh a partitioned mine's engines run on —
    this rank's row, or None for the bare single-device route — or
    ``_PARTITION_SKIP`` (logged) when the mesh cannot split ``parts``
    ways, so an override that cannot split this topology does not fail
    the whole enumeration."""
    from spark_fsm_tpu_torch.parallel import partition as PN
    from spark_fsm_tpu_torch.utils.obs import log_event

    try:
        rows = PN.submeshes(mesh, parts)
    except ValueError as exc:
        log_event("partition_config_invalid", reason=str(exc),
                  at="enumerate_shapes")
        return _PARTITION_SKIP
    return next((r for r in rows if r is not None), None)
