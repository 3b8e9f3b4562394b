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

Port: the registry half of ``spark_fsm_tpu/utils/shapes.py`` (the
``key_*`` formats, :func:`record`, :func:`recorded`,
:func:`reset_recorded` and :func:`drift`).  The enumerator
(``WorkloadSpec``, ``enumerate_shapes``) belongs to the boot prewarm,
which the port does not have yet.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, List, Optional

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
