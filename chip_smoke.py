#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``spark_fsm_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, one printed line each (any failure raises and exits non-zero):
  1. the card: ``nvidia-smi`` name and power limit, torch's device name;
  2. build every kernel from ``csrc/`` with nvcc (sm_90a), one nvcc per
     source, and the native tokenizer (``data/_fasttok.c``) with gcc, all
     started together; print which tokenizer runs;
  3. the pair-support kernel against its plain PyTorch version on the card,
     exact equality, W in {1, 2, 3} on ragged shapes and at the main
     path's launches, plus the candidate extraction of ``batch_supports``;
  4. the kernel and its plain version timed with CUDA events at the
     headline launch (P=2048, NI=360, S=77,504, W=1), at the queue
     engine's wide and late waves (P=1024 and P=128, NI=384), at the
     classic engine's first launch (P=720, NI=360) and at the stream
     sweep's widest level (P=2048, NI=128, S=131,072), beside the least
     time the card could take for the same work;
  5. the main path at full data size: ``mine_spade_torch`` on a
     BMS-WebView-2-shaped database (77,500 sequences) at minsup 0.1 %,
     which the router sends to the queue engine, byte-identical to the CPU
     oracle (a child process started at the top, as phase 13's), with
     one pair-support launch per wave; then the same mine
     pinned to the classic engine (``fused="never"``) and to the dense
     engine (``fused="dense"``, one launch per level), each byte-identical
     to the oracle; at minsup 50 the dense engine's frontier (and the
     queue engine's children a wave) overflow and ``fused="dense"`` and
     ``"auto"`` fall back to the classic engine, byte-identical to the
     SPAM engine's mine; the mine checkpointed (the queue engine in
     segments; a
     mid-mine snapshot resumed in the classic engine), byte-identical; the
     vertical build timed with the native and the numpy tokenizer;
  6. a multiword mine (W >= 2) against the oracle;
  7. the rule-support kernel against its plain PyTorch version on the card,
     exact equality, W in {1, 2, 3} on ragged shapes, every km of the
     launch planner's ladder, unused (-1) slots, stores at and one past the
     largest the staged path holds, and the resident route's waves;
  8. the rule-support kernel and its plain version timed with CUDA events at
     the headline launch (C=8192, km=2, M=256, S=990,000, W=1), at km=1 and
     at the resident route's wide and late waves (C=512 and C=64, km=4),
     beside the least time the card could take for the same work;
  9. the TSR path at full data size: ``mine_tsr_torch`` on a Kosarak-shaped
     database (990,000 sequences) with k=100, minconf=0.5, max_side=2,
     every rule's counts recounted on the host, the kernel's launches
     counted (phase 21 holds the mine through the kernel against the
     plain evaluator's on a tenth of the database); the vertical build
     timed, and both tokenizers on a tenth of the database;
 10. the TSR path against the copied CPU oracle (``mine_tsr_cpu``) at 1 %
     of that size, and on a multiword (W >= 2) database;
 11. the extension-count-prune kernel against its plain PyTorch version on
     the card, exactly (counts and survivor masks), W in {1, 2, 3}, ragged
     P and S, all-zero pad item rows, thresholds 1, the median count and
     one above the largest, with the live-row hint (``n_live``) and
     without; at threshold 1 its counts equal the pair-support kernel's;
 12. the extension-count-prune kernel and its plain version timed with
     CUDA events at the SPAM engine's wave on the MSNBC-shaped database
     (P = 2 x the engine's node batch on this card, NI=64 of which 17 rows
     are live, S=990,016, W=1) and at the BMS-WebView-2-shaped dense wave
     (P=128, NI=64, 26 live, S=77,504, W=1): without the hint against the
     bound over all 64 lanes, with it at threshold 1 and at the median
     count against the bound over the live lanes; the kernel per launch
     over 50 back-to-back calls (each with its one zero-fill) queued behind
     a spinning kernel, since a launch is shorter than the wrapper's host
     work;
 13. the SPAM path at full data size: ``mine_spam_torch`` on an
     MSNBC-shaped database (990,000 sequences) at minsup 0.5 %, which the
     planner routes to SPAM, byte-identical to the CPU oracle and to the
     queue engine, with one kernel launch per wave; the vertical build
     timed, and both tokenizers on a tenth of the database;
 14. the SPAM path on the hybrid plan: phase 5's database at minsup 0.1 %
     (dense items as wave lanes, sparse items as pair lanes),
     byte-identical to phase 5's oracle result, and a multiword SPAM mine
     against the oracle;
 15. TSR's resident-frontier route at full data size: phase 9's
     Kosarak-shaped vertical DB through ``TsrTorch`` with k=100,
     minconf=0.5 and no side cap, pinned to the resident route
     (``resident="always"``) and to the host loop (``"never"``),
     byte-identical to each other and to the host recount, the
     rule-support kernel launched once a wave, its bound summed over the
     rows each launch names; what ``auto`` picks at this size; at 1 % of
     it, ``mine_tsr_torch``'s ``auto`` takes the resident route,
     byte-identical to ``mine_tsr_cpu``, and ``auto`` and the host loop
     are timed warm in turns;
 16. constrained SPADE (cSPADE): ``mine_cspade_torch`` on a Gazelle-shaped
     database (59,000 sequences) with maxgap 2, maxwindow 5 and minsup
     0.5 %, and at 10 % of that size, each byte-identical to the copied
     CPU oracle ``mine_cspade``.  The oracles run in two child processes
     started at the top, so they overlap the card phases;
 17. streaming windows at full size: the MSNBC-shaped database cut into
     ten micro-batches of 99,000 sequences, a window of five, minsup
     0.5 %, pushed through ``IncrementalWindowMiner`` (the pair-support
     kernel once a swept level) and through the re-mine ``WindowMiner``
     (``mine_spade_torch(..., shape_buckets=True)``): after every push the
     two pattern texts are byte-identical, and after pushes 1, 5 and 10
     they equal the copied oracle's mine of the window (three more child
     processes started at the top); per push and route the wall, the
     incremental miner's stage split and counters, the kernel's launches
     and the peak device memory;
 18. the repair fold and multiword batches on the card: a stream of small
     two-word batches at an absolute minsup that moves patterns across
     the border both ways, every push byte-identical to the oracle and to
     the gather-join branch (``use_kernel=False``), with nodes repaired
     after the first push;
 19. ``shape_buckets=True`` on the card: SPADE's ``auto`` route on phase
     5's database, SPAM on phase 17's first batch (10 % of phase 13's
     size), TSR on phase 15's 1 % database and cSPADE on phase 16's 10 %
     database, each against the oracle text an earlier phase holds, with
     the route each took;
 20. prediction scoring at the service's ``[predict]`` defaults over three
     rule sets that earlier phases hold: phase 9's Kosarak-shaped TSR
     rules and, through ``rules_from_patterns``, phase 5's
     BMS-WebView-2-shaped SPADE patterns and phase 13's MSNBC-shaped SPAM
     patterns.  Each is serialized, built through the artifact cache at
     the depth each request needs, and 2,050 prefixes drawn from its
     database (the empty one and an absent item among them) are scored in
     waves of 1, 16 and 64 rows at m = 8 through ``score_wave``, every row
     byte-identical to ``predict_host`` as sorted JSON; per wave width the
     wave's device time (CUDA events) and wall, median and p99, beside
     the host's pack, scoring (upload, launches, readback wait) and
     decode; the widest wave's peak device
     memory; then 16 threads send 512 requests through the broker with
     its window on (fused share, waves).  No hand kernel runs on this
     path (the scorer is torch code): B1, B2 and B3 launch 0 times;
 21. sequence meshes on the card (``parallel.launch.spawn_world``): a
     tenth of phase 9's database mined on one device through the kernel
     and through the plain evaluator, byte-identical; then a 1-rank NCCL
     world and a 2-rank gloo world whose ranks share the card.  Every rank mines, through the entry points with ``mesh=``:
     phase 5's BMS-WebView-2-shaped SPADE through ``auto`` (the queue
     engine) and ``fused="never"``, phase 13's MSNBC-shaped SPAM (B1 on
     the shard, the all-reduce, the threshold; B3 never), a tenth of
     phase 9's Kosarak-shaped TSR (B2; the host loop, never the resident
     route; held against a one-device mine of that tenth),
     phase 16's full-size Gazelle-shaped cSPADE and the first five pushes
     of phase 17's stream through ``IncrementalWindowMiner(mesh=)``; each
     answer must equal the earlier phase's text (SHA-256 of the canonical
     text) on every rank.  Co-located ranks take the one-device pool
     budget divided by the ranks on the card, and the sum of their peaks
     must fit the card.  ``[mesh]`` lines print per world and mine the
     route, each rank's B1/B2 launches and kernel time (CUDA events
     around each launch), the all-reduces' count and time, each rank's
     wall beside the one-device wall of the earlier phase, and each
     rank's peak memory, with the card's name and power limit.  The
     2-rank world also mines in two class partitions
     (``partition_parts=2``, one partition row a rank, each on the bare
     one-device route, the exchange through gloo): phase 9's TSR, phase
     5's SPADE through ``auto`` and phase 13's SPAM, each rank
     byte-identical to the earlier phase's text, with its exchange rounds
     and bytes; in the 1-rank world ``partition_parts=2`` raises the
     ``ValueError`` of a mesh that does not split;
 22. class-partitioned mines at full size in one process (``mesh=None``:
     the partitions mined in turn on the card), each held by SHA-256 of
     its text against the earlier phase's: phase 9's Kosarak-shaped TSR
     (``max_side=2``) at 2 parts through ``TsrPartitioned`` on phase 9's
     vertical DB, beside the unpartitioned ``TsrTorch`` on it; phase 15's
     1 % TSR (``max_side=None``, each slice on the resident route) at 2
     parts (at 4 its first slice alone evaluates about 15 times the
     unpartitioned mine's candidates: ``profile_mine tsr-partition``);
     phase 5's BMS SPADE at 2
     parts through ``auto`` (queue slices) and ``"never"`` (classic);
     phase 13's MSNBC SPAM and phase 16's Gazelle cSPADE at 2 parts; and a
     composite checkpoint of the BMS mine (a snapshot at every chance)
     resumed from a snapshot taken mid-slice.  ``[part]`` lines print the
     plan's imbalance, per partition the wall, the candidates evaluated
     and the B1/B2/B3 launches and kernel time (CUDA events), the
     exchanges (one a deepening round on TSR, one a mine otherwise), the
     peak and the unpartitioned wall of the same run; B1, B2 and B3 must
     each launch on the partitioned path;
 23. the service: the port's ``serve_background()`` (default device
     ``cuda``) in this process, with a source registered through
     ``service.sources.register`` that names the full-size databases of
     phases 9, 13, 16 and 5.  Over HTTP: ``TSR_TPU`` k=100, minconf 0.5,
     ``max_side=2`` on the Kosarak-shaped database, ``SPAM_TPU`` at
     0.5 % on the MSNBC-shaped one, ``SPADE_TPU`` with maxgap 2 and
     maxwindow 5 on the Gazelle-shaped one, ``SPADE_TPU`` at 0.1 % on the
     BMS-WebView-2-shaped one and that request again, which the engine
     cache answers (``store_cache_hit``).  Every ``/get/*`` body equals
     ``model.serialize_*`` of the earlier phase's library result by
     SHA-256; B2, B3 and B1 launch during the TSR, SPAM and SPADE
     requests (the cSPADE engine runs torch ops only); ``/predict`` against the TSR and SPADE results equals
     ``predict_host`` on 16 prefixes each; ``/admin/stats`` reports
     ``backend: "cuda"``.  ``[service]`` lines print each job's
     submit-to-finished wall beside the library walls of the same call,
     the cache hit's wall, ``/predict`` latency and the peak device
     memory, with the card's name and power limit;
 24. the warm and fused service on the card.  (a) Two fresh child
     processes (``python -m spark_fsm_tpu_torch.service.app --device
     cuda``, so the CUDA context, the kernel libraries' loads and the
     caching allocator start cold; both share the checkout's build
     directory, as two restarts of one service would): one boots
     without prewarm, the other with ``[prewarm] enabled`` at phase 5's
     BMS-WebView-2-shaped SPADE envelope (the boot prewarm, before it
     listens), then takes ``/admin/prewarm`` at phase 15's 1 %
     Kosarak-shaped TSR envelope.  Each takes ``SPADE_TPU`` at 0.1 % on
     the BMS database and ``TSR_TPU`` k=100, minconf 0.5 (no side cap:
     the resident route) on the 1 % database as ``/train`` requests
     (INLINE), each body equal to the library result by SHA-256.  Printed:
     each child's boot wall, the prewarm report (keys, walls, builds and
     first loads), each first job's wall, and ``/admin/shapes``: its
     ``drift`` after the BMS job and, after the TSR job, the recorded keys
     outside both prewarms' enumerations, each ``[]``; a report row with
     an ``error`` fails the phase.  (b) In this process, a service with
     ``[fusion] enabled`` and two miner workers takes two ``TSR_TPU``
     jobs at once, their first waves held in the broker's window until
     both jobs have one pending: on phase 9's Kosarak-shaped database
     (k=100, minconf 0.5, ``max_side=2``), both bodies equal to phase 9's
     library result by SHA-256, with the broker's decisions printed (at
     this size every wave fills one 8,192-lane launch, so the cost model
     rejects each group: fusing saves no dispatch and pays the prep
     concat); then on phase 13's MSNBC-shaped database (990,000
     sequences, 17 items; k=100, minconf 0.5, ``max_side=2``), where a
     wave's candidates leave its launches part-filled: both bodies equal
     the library result by SHA-256,
     ``fsm_fusion_launches_total{cross_job="true"}`` must rise and a fused
     store the broker built gives B2 equal to its plain version.  A
     full-size fused store laid out as the broker lays one out (two
     engines' first-round stores of phase 9's vertical DB) gives B2 equal
     to plain, timed against one job's store with the same candidates
     (the walk path against the staged).  (c) An injected ``device.oom``
     on the first broker launch of the MSNBC-shaped pair (a cross-job
     launch halved by the engine's own ladder) and on the first kernel
     launch of a Kosarak TSR mine on phase 9's vertical DB:
     ``degraded_launches`` >= 1 in each job and the rules byte-identical;
 25. the service on a mesh.  (a) Under a meshguard (``dead_after=1``),
     phase 9's Kosarak-shaped TSR at 2 parts (``TsrPartitioned`` on phase
     9's vertical DB) and phase 5's BMS SPADE at 2 parts, each with an
     injected ``device.dispatch`` fault on part 0's first dispatch: the
     dead row's slice is adopted in this process, every result
     byte-identical to the earlier phase's, dead rows ``[0]`` and epoch 1,
     the wall beside phase 22's healthy one.  (b) The same TSR drill on a
     tenth of the database in a 2-rank gloo world sharing the card, the
     fault on rank 0's row: rank 1 adopts part 0 through the exchange, the
     rules' SHA-256 equal on both ranks and to phase 21's one-device mine,
     the walls beside phase 21's healthy ones; then a service booted with
     ``[engine] mesh_devices = 2`` through the launcher (``python -m
     spark_fsm_tpu_torch.service.app``: rank 0 serves, rank 1 replays)
     takes phase 5's BMS SPADE and the tenth's TSR as ``/train`` jobs
     (FILE sources) and phase 17's first five pushes, every body equal to
     the library's by SHA-256, ``/admin/stats`` ``mesh_devices`` 2, and
     exits 0 on SIGTERM.  (c) A service in this process with ``[prewarm]``
     at phase 17's stream envelope (``stream_batch_sequences`` =
     ``stream_seq_floor`` = 99,000) takes the ten pushes over HTTP: route
     ``incremental``, each push's patterns equal to phase 17's by SHA-256,
     B1 on every push with a tracked tree, ``/admin/shapes`` drift ``[]``
     (the reference's four sweep row buckets hold its widest level).  ``[meshguard]``, ``[world]`` and
     ``[stream-service]`` lines print the walls beside the library's,
     launches and peaks with the card's name and power limit.
     ``python3 chip_smoke.py --phase 25`` runs this phase alone on
     inputs made here through the library.
Then one JSON line with every kernel's numbers, and as the last line
``{"ok": true, "device": {...}}``.  Without a CUDA card it exits non-zero
and prints no result.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import socket
import statistics
import subprocess
import sys
import threading
import time

import numpy as np

# Card peaks for the bound (H100 SXM data sheet, as in the repository's
# measurement notes): 3.35 TB/s of device memory, and int32 work on the CUDA
# cores at 64 lanes per SM per clock — a quarter of the 67 TFLOP/s fp32
# rate, which counts 128 lanes and two operations per fused multiply-add.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 4

# (P, NI, S, W) of the timed launches: the headline launch; the main path's
# queue waves, wide (2 x nb = 1024 rows) and late (2 x nb_late = 128 rows)
# over the item axis padded to 384; and the classic engine's first launch
# (the 360 frequent items as parents, plain and s-ext-transformed rows)
HEADLINE = (2048, 360, 77504, 1)
WIDE_WAVE = (1024, 384, 77504, 1)
LATE_WAVE = (128, 384, 77504, 1)
CLASSIC_LAUNCH = (720, 360, 77504, 1)
# the stream's widest sweep level: 2 x the level's pow2 width (phase 17
# checks it) over the batch store's 128 item rows (17 live items padded to
# the reference's I_TILE) and its bucketed 131,072 sequences
STREAM_SWEEP = (2048, 128, 131072, 1)
# (C, km, M, S, W) of the timed rule-support launches: the TSR path's
# headline launch (8192 candidates at km = 2 over the top 256 items of the
# Kosarak-shaped database) and the same launch at km = 1
RULE_HEADLINE = (8192, 2, 256, 990000, 1)
RULE_KM1 = (8192, 1, 256, 990000, 1)
# the resident route's waves on the same stores: nb = 512 popped entries
# (the caps on an 80 GB card) and the late width nb_late = 64, at the
# ring's km = 4 item slots a side
RULE_RESIDENT_WIDE = (512, 4, 256, 990000, 1)
RULE_RESIDENT_LATE = (64, 4, 256, 990000, 1)
# (P, NI, S, W) of the timed extension-count-prune launch at the BMS dense
# wave (64 nodes, 26 dense items padded to 64); the MSNBC wave's P is twice
# the engine's node batch on this card, set in main()
BMS_WAVE = (128, 64, 77504, 1)


# the stream of phase 17: MSNBC-shaped micro-batches, a window of five,
# minsup 0.5 % of the window; the copied oracle mines the window after
# pushes 1, 5 and 10 in child processes (the wall first, then the text)
STREAM_PUSHES, STREAM_KEEP, STREAM_MINSUP = 10, 5, 0.005
STREAM_ORACLE_PUSHES = (1, 5, 10)
STREAM_ORACLE = r"""
import sys, time
from spark_fsm_tpu_torch.data.synth import msnbc_like
from spark_fsm_tpu_torch.data.vertical import abs_minsup
from spark_fsm_tpu_torch.models.oracle import mine_spade
from spark_fsm_tpu_torch.utils.canonical import patterns_text
push, n_push, keep, rel = (int(sys.argv[1]), int(sys.argv[2]),
                           int(sys.argv[3]), float(sys.argv[4]))
db = msnbc_like(scale=1.0, fast=True)
per = len(db) // n_push
lo = max(0, push - keep) * per
hi = push * per if push < n_push else len(db)
window = db[lo:hi]
t0 = time.perf_counter()
res = mine_spade(window, abs_minsup(rel, len(window)))
print(f"{time.perf_counter() - t0:.3f}")
print(patterns_text(res), end="")
"""
# phase 20: prediction scoring; the broker run's requests and client threads
PREDICT_REQUESTS = 512
PREDICT_THREADS = 16
# phase 18's multiword stream: batches of 40 sequences of about 40
# itemsets (two words), a window of two, an absolute minsup
MW_STREAM = dict(seed=8, batches=5, per_batch=40, minsup=70)


# phase 21: the mesh worlds, both on the one card: (backend, ranks)
MESH_WORLDS = (("nccl", 1), ("gloo", 2))
MESH_STREAM_PUSHES = 5
# phase 21's Kosarak-shaped TSR: a tenth of phase 9's database (the
# reduce's cost shows at that size; phases 9 and 22 mine the full one)
MESH_KOSARAK_SCALE = 0.1
# phases 21 and 22: the class partitions of the partitioned mines
PARTITION_PARTS = 2


def digest(text: str) -> str:
    return hashlib.sha256(text.encode()).hexdigest()


def _timed_kernel(torch, fn, sink: list):
    """``fn`` (a kernel's wrapper) with CUDA events recorded around each
    call on the current stream; the wrapper's own launch count moves to
    this function's ``launches``, which the wrapper increments."""
    def timed(*args, **kwargs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn(*args, **kwargs)
        b.record()
        sink.append((a, b))
        return out
    timed.launches = 0
    return timed


def mesh_rank(mesh, plan: dict) -> dict:
    """Phase 21's mines on one mesh rank (run by ``spawn_world``): each
    answer's digest, route, B1/B2/B3 launches and kernel ms, all-reduces
    and their time, and wall; the rank's peak memory."""
    import torch

    from spark_fsm_tpu_torch.data.synth import (
        gazelle_like, kosarak_like, msnbc_like)
    from spark_fsm_tpu_torch.data.vertical import abs_minsup
    from spark_fsm_tpu_torch.models._common import auto_pool_bytes
    from spark_fsm_tpu_torch.models.spade import mine_spade_torch
    from spark_fsm_tpu_torch.models.spade_constrained import mine_cspade_torch
    from spark_fsm_tpu_torch.models.spam_bitmap import mine_spam_torch
    from spark_fsm_tpu_torch.models.tsr import mine_tsr_torch
    from spark_fsm_tpu_torch.ops import extend_prune as EP
    from spark_fsm_tpu_torch.ops import pair_support as PS
    from spark_fsm_tpu_torch.ops import rule_support as RS
    from spark_fsm_tpu_torch.parallel.mesh import all_reduce_sum
    from spark_fsm_tpu_torch.streaming import IncrementalWindowMiner
    from spark_fsm_tpu_torch.utils.canonical import patterns_text, rules_text

    kernels = (("b1", PS, "pair_supports"), ("b2", RS, "rule_supports"),
               ("b3", EP, "extend_count_prune"))
    sinks = {key: [] for key, _, _ in kernels}
    for key, mod, name in kernels:
        setattr(mod, name, _timed_kernel(torch, getattr(mod, name),
                                         sinks[key]))
    # co-located ranks split the one-device pool budget
    pool = auto_pool_bytes(mesh.device) // plan["ranks_on_card"]
    out = {"rank": mesh.rank, "gen_s": {}, "mines": {}}
    # the first collective sets the communicator up: not a mine's
    all_reduce_sum(torch.zeros(1, dtype=torch.int32, device=mesh.device),
                   mesh)

    def run(label, fn):
        for key, mod, name in kernels:
            sinks[key].clear()
            getattr(mod, name).launches = 0
        mesh.reset_counters()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(mesh.device)
        t0 = time.perf_counter()
        text, stats = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        red = mesh.reduce_stats()
        out["mines"][label] = {
            "digest": digest(text), "wall_s": wall,
            "fused": stats.get("fused"), "resident": stats.get("resident"),
            "route": (f"fused={stats['fused']!r}" if "fused" in stats else
                      f"resident={bool(stats.get('resident'))}"
                      if label == "tsr" else stats.get("route", "-")),
            "launches": {key: getattr(mod, name).launches
                         for key, mod, name in kernels},
            "kernel_ms": {key: sum(a.elapsed_time(b) for a, b in sinks[key])
                          for key in sinks},
            "all_reduces": red["all_reduces"],
            "all_reduce_ms": red["all_reduce_ms"],
            "waves": stats.get("waves"), "evaluated": stats.get("evaluated"),
            "exchanges": stats.get("partition_exchanges"),
            "cross_bytes": stats.get("partition_cross_bytes"),
            "rounds": stats.get("deepening_rounds"),
            "peak": torch.cuda.max_memory_allocated(mesh.device),
        }

    def gen(name, make):
        t0 = time.perf_counter()
        db = make()
        out["gen_s"][name] = time.perf_counter() - t0
        return db

    db = plan["bms_db"]   # phase 5's database (its generator is slow)
    minsup = abs_minsup(0.001, len(db))
    for fused in ("auto", "never"):
        def spade(fused=fused):
            st: dict = {}
            extra = {"pool_bytes": pool} if fused == "never" else {}
            res = mine_spade_torch(db, minsup, mesh=mesh, fused=fused,
                                   stats_out=st, **extra)
            return patterns_text(res), st
        run(f"spade {fused}", spade)
    # class partitions: one row a rank on an even world; a 1-rank world
    # cannot hold two rows and must refuse
    parts = PARTITION_PARTS if mesh.size % PARTITION_PARTS == 0 else 0
    if mesh.size == 1:
        try:
            mine_spade_torch(db, minsup, mesh=mesh,
                             partition_parts=PARTITION_PARTS)
        except ValueError as exc:
            out["refused"] = str(exc)
    if parts:
        def spade_part():
            st: dict = {}
            res = mine_spade_torch(db, minsup, mesh=mesh,
                                   partition_parts=parts, stats_out=st)
            return patterns_text(res), st
        run("part spade auto", spade_part)
    db = gen("msnbc", lambda: msnbc_like(scale=1.0, fast=True))
    minsup = abs_minsup(0.005, len(db))

    def spam(**kw):
        st: dict = {}
        res = mine_spam_torch(db, minsup, mesh=mesh, pool_bytes=pool,
                              stats_out=st, **kw)
        return patterns_text(res), st
    run("spam", spam)
    if parts:
        run("part spam", lambda: spam(partition_parts=parts))
    per = len(db) // plan["stream_pushes"]
    inc = IncrementalWindowMiner(plan["stream_minsup"],
                                 max_batches=plan["stream_keep"], mesh=mesh)
    for push in range(1, MESH_STREAM_PUSHES + 1):
        batch = db[(push - 1) * per:push * per]
        run(f"stream push {push}",
            lambda batch=batch: (patterns_text(inc.push(batch)), inc.stats))
    del inc, db
    db = gen("kosarak", lambda: kosarak_like(scale=MESH_KOSARAK_SCALE,
                                             fast=True))

    def tsr(**kw):
        st: dict = {}
        res = mine_tsr_torch(db, 100, 0.5, max_side=2, mesh=mesh,
                             stats_out=st, **kw)
        return rules_text(res), st
    run("tsr", tsr)
    if parts:
        run("part tsr", lambda: tsr(partition_parts=parts))
    db = gen("gazelle", lambda: gazelle_like(scale=1.0, fast=True))
    minsup = abs_minsup(0.005, len(db))

    def cspade():
        st: dict = {}
        res = mine_cspade_torch(db, minsup, maxgap=2, maxwindow=5,
                                mesh=mesh, pool_bytes=pool, stats_out=st)
        return patterns_text(res), st
    run("cspade", cspade)
    out["peak"] = max(rec["peak"] for rec in out["mines"].values())
    return out


def mesh_phase(torch, want: dict, single_walls: dict, card: str,
               bms_db, tenth: dict) -> dict:
    """Phase 21: both mesh worlds on the card, every rank's answers held
    against the earlier phases' digests ``want``; the ranks get phase 5's
    database ``bms_db`` and make the others.  The one-device mine of the
    tenth of phase 9's database is also held against its plain route,
    and ``tenth`` gets (database, serialization, wall) for phase 25.
    Returns the mesh path's B1 and B2 launches (rank 0 of each world)."""
    from spark_fsm_tpu_torch.data.synth import kosarak_like
    from spark_fsm_tpu_torch.models.tsr import mine_tsr_torch
    from spark_fsm_tpu_torch.parallel.launch import spawn_world
    from spark_fsm_tpu_torch.service import model as SM
    from spark_fsm_tpu_torch.utils.canonical import rules_text

    t_phase = time.perf_counter()
    db = kosarak_like(scale=MESH_KOSARAK_SCALE, fast=True)
    t0 = time.perf_counter()
    rules = mine_tsr_torch(db, 100, 0.5, max_side=2)
    torch.cuda.synchronize()
    wall = round(time.perf_counter() - t0, 3)
    text = rules_text(rules)
    t0 = time.perf_counter()
    plain = rules_text(mine_tsr_torch(db, 100, 0.5, max_side=2,
                                      use_kernel=False))
    torch.cuda.synchronize()
    check(plain == text, "the tenth's TSR mine through the kernel differs "
          "from the plain evaluator's")
    print(f"[mesh] kosarak_like(scale={MESH_KOSARAK_SCALE}) TSR on one "
          f"device: {len(rules)} rules byte-identical to the plain "
          f"evaluator's mine; {wall} s, plain route "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    want = dict(want, tsr=digest(text))
    single_walls = dict(single_walls, tsr=(wall,))
    tenth.update(db=db, payload=SM.serialize_rules(rules), wall=wall,
                 digest=digest(text))
    del db, text, rules, plain
    total = torch.cuda.get_device_properties(0).total_memory
    torch.cuda.empty_cache()
    launched = {}
    for backend, ranks in MESH_WORLDS:
        plan = {"ranks_on_card": ranks, "stream_pushes": STREAM_PUSHES,
                "stream_keep": STREAM_KEEP, "stream_minsup": STREAM_MINSUP,
                "bms_db": bms_db}
        t0 = time.perf_counter()
        res = spawn_world(mesh_rank, ranks, backend, "cuda:0", (plan,),
                          timeout_s=900,
                          threads=max(1, (os.cpu_count() or 1) // ranks))
        world_s = time.perf_counter() - t0
        for r in res:
            for label, rec in r["mines"].items():
                check(rec["digest"] == want[label.removeprefix("part ")],
                      f"{backend} x{ranks} rank {r['rank']}: {label} "
                      f"differs from the one-device oracle text")
                if label.startswith("part "):
                    # one-rank rows: the bare route, no in-row reduce;
                    # the exchange is the one collective
                    check(rec["exchanges"] == (rec["rounds"] if label ==
                                               "part tsr" else 1),
                          f"{backend} x{ranks}: {label} made "
                          f"{rec['exchanges']} exchanges")
                else:
                    check(rec["all_reduces"] > 0,
                          f"{backend} x{ranks}: {label} made no all-reduce")
            if ranks == 1:
                check("does not split into 2 equal" in r.get("refused", ""),
                      f"a 1-rank world at partition_parts=2 did not raise "
                      f"the ValueError: {r.get('refused')!r}")
            else:
                pm = r["mines"]
                check(pm["part spade auto"]["launches"]["b1"] > 0
                      and pm["part spam"]["launches"]["b3"] > 0
                      and pm["part tsr"]["launches"]["b2"] > 0,
                      f"{backend} x{ranks}: partitioned launches "
                      f"{[pm[k]['launches'] for k in pm if k.startswith('part ')]}")
            m = r["mines"]
            check(m["spade auto"]["fused"] == "queue",
                  f"{backend} x{ranks}: auto routed to "
                  f"{m['spade auto']['fused']!r}")
            check(m["spade never"]["fused"] is False,
                  f"{backend} x{ranks}: never did not route classic")
            check(m["spam"]["launches"]["b1"] > 0
                  and m["spam"]["launches"]["b3"] == 0,
                  f"{backend} x{ranks}: SPAM launches {m['spam']['launches']}")
            check(m["tsr"]["launches"]["b2"] > 0 and not m["tsr"]["resident"],
                  f"{backend} x{ranks}: TSR launches {m['tsr']['launches']}, "
                  f"resident {m['tsr']['resident']}")
        peaks = [r["peak"] for r in res]
        check(sum(peaks) <= total, f"{backend} x{ranks}: the ranks' peaks "
              f"{peaks} exceed the card's {total} B")
        for label in res[0]["mines"]:
            recs = [r["mines"][label] for r in res]
            one = single_walls.get(label.removeprefix("part "))
            launches = [(rec["launches"]["b1"], rec["launches"]["b2"],
                         rec["launches"]["b3"]) for rec in recs]
            print(f"[mesh] {backend} x{ranks} {label}: byte-identical to the "
                  f"one-device text on every rank; route {recs[0]['route']}; "
                  f"per rank (B1, B2, B3) launches {launches}, B1 ms "
                  f"{[round(rec['kernel_ms']['b1'], 3) for rec in recs]}, "
                  f"B2 ms {[round(rec['kernel_ms']['b2'], 3) for rec in recs]}, "
                  f"all-reduces {[rec['all_reduces'] for rec in recs]} taking "
                  f"{[round(rec['all_reduce_ms'], 3) for rec in recs]} ms; "
                  f"wall {[round(rec['wall_s'], 3) for rec in recs]} s "
                  f"against one device {one} s; peak "
                  f"{[rec['peak'] for rec in recs]} B"
                  + (f"; exchanges {[rec['exchanges'] for rec in recs]} "
                     f"over {recs[0]['rounds']} rounds, bytes "
                     f"{[rec['cross_bytes'] for rec in recs]}"
                     if label.startswith("part ") else ""), flush=True)
        launched[(backend, ranks)] = {
            label: res[0]["mines"][label]["launches"]
            for label in res[0]["mines"]}
        if "part tsr" in res[0]["mines"]:
            tenth["world part tsr"] = [round(r["mines"]["part tsr"]["wall_s"],
                                             3) for r in res]
        if ranks == 1:
            print(f"[mesh] {backend} x1 partition_parts=2 raised: "
                  f"{res[0]['refused']}", flush=True)
        print(f"[mesh] {backend} x{ranks} world: {world_s:.1f} s with spawn "
              f"and data; generators {res[0]['gen_s']}; largest peak per "
              f"rank {peaks} B (sum {sum(peaks)} of {total} B); card {card}",
              flush=True)
    print(f"[mesh] phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launched


class PartMeter:
    """Phase 22's meter: B1, B2 and B3 wrapped with CUDA events
    (``_timed_kernel``) while it is entered, and each partition's
    stretches of work (a TSR round's slice, a SPADE/SPAM/cSPADE slice)
    timed and charged with the launches, kernel events and candidates
    inside them."""

    def __init__(self, torch, kernels):
        self.torch = torch
        self.kernels = kernels   # ((key, module, wrapper name), ...)
        self.sinks = {key: [] for key, _, _ in kernels}
        self.parts: dict = {}
        self._saved: list = []

    def __enter__(self):
        for key, mod, name in self.kernels:
            fn = getattr(mod, name)
            self._saved.append((mod, name, fn))
            setattr(mod, name, _timed_kernel(self.torch, fn, self.sinks[key]))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)
        self._saved.clear()

    def reset(self) -> None:
        self.parts = {}
        for key, mod, name in self.kernels:
            self.sinks[key].clear()
            getattr(mod, name).launches = 0

    def launches(self) -> dict:
        return {key: getattr(mod, name).launches
                for key, mod, name in self.kernels}

    def stretch(self, part, work, fn, *args, **kwargs):
        """``fn(*args, **kwargs)`` as partition ``part``'s work;
        ``work()`` reads the candidates evaluated so far."""
        self.torch.cuda.synchronize()
        l0, w0 = self.launches(), work()
        i0 = {key: len(v) for key, v in self.sinks.items()}
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            self.torch.cuda.synchronize()
            rec = self.parts.setdefault(part, {
                "wall_s": 0.0, "work": 0,
                "launches": {key: 0 for key in self.sinks},
                "events": {key: [] for key in self.sinks}})
            rec["wall_s"] += time.perf_counter() - t0
            rec["work"] += work() - w0
            for key, n in self.launches().items():
                rec["launches"][key] += n - l0[key]
                rec["events"][key] += self.sinks[key][i0[key]:]

    def summary(self) -> str:
        out = []
        for p in sorted(self.parts):
            rec = self.parts[p]
            ms = {key: round(sum(a.elapsed_time(b) for a, b in ev), 3)
                  for key, ev in rec["events"].items()}
            out.append(f"part {p}: {rec['wall_s']:.3f} s, evaluated "
                       f"{rec['work']}, (B1, B2, B3) launches "
                       f"{tuple(rec['launches'].values())} taking "
                       f"{tuple(ms.values())} ms")
        return "; ".join(out)


class CompositeStore:
    """A checkpoint for the partitioned mines: a snapshot at every chance,
    each kept as a store would hold it (JSON), resuming ``state``."""

    def __init__(self, state=None, every_s: float = 0.0):
        self.state, self.every_s, self.saved = state, every_s, []

    def load(self):
        return self.state

    def save(self, state):
        self.saved.append(json.loads(json.dumps(state)))


def partition_phase(torch, inputs: dict, want: dict, single_walls: dict,
                    card: str, part_walls: dict) -> dict:
    """Phase 22: the partitioned mines of ``inputs`` in this process, each
    held against the earlier phase's digest in ``want``; ``part_walls``
    gets each mine's wall by label.  Returns each kernel's launches on the
    partitioned path."""
    from spark_fsm_tpu_torch.models import tsr as TT
    from spark_fsm_tpu_torch.models.spade import mine_spade_torch
    from spark_fsm_tpu_torch.models.spade_constrained import mine_cspade_torch
    from spark_fsm_tpu_torch.models.spam_bitmap import mine_spam_torch
    from spark_fsm_tpu_torch.ops import extend_prune as EP
    from spark_fsm_tpu_torch.ops import pair_support as PS
    from spark_fsm_tpu_torch.ops import rule_support as RS
    from spark_fsm_tpu_torch.parallel import partition as PN
    from spark_fsm_tpu_torch.utils.canonical import patterns_text, rules_text

    t_phase = time.perf_counter()
    meter = PartMeter(torch, (("b1", PS, "pair_supports"),
                              ("b2", RS, "rule_supports"),
                              ("b3", EP, "extend_count_prune")))
    launched = {key: 0 for key in meter.sinks}
    orig_round = TT.TsrTorch._mine_restricted
    orig_slices = PN.mine_partitioned_slices

    def tsr_round(self, m, *args, **kwargs):
        part = None if self._partition is None else self._partition[1]
        return meter.stretch(part, lambda: self.stats["evaluated"],
                             orig_round, self, m, *args, **kwargs)

    def slices(*, mine_part, stats=None, **kwargs):
        def metered(p, *args):
            return meter.stretch(p, lambda: stats.get("candidates", 0),
                                 mine_part, p, *args)
        return orig_slices(mine_part=metered, stats=stats, **kwargs)

    def measured(label, fn, want_digest, text_of, unpart, kernel):
        """One partitioned mine: parity, launches, exchanges, peak."""
        meter.reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res, stats = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        part_walls[label] = round(wall, 3)
        peak = torch.cuda.max_memory_allocated()
        check(digest(text_of(res)) == want_digest,
              f"the partitioned {label} differs from the earlier phase's text")
        n = meter.launches()
        check(n[kernel] > 0, f"the partitioned {label} launched {kernel} "
              f"0 times: {n}")
        for key in launched:
            launched[key] += n[key]
        rounds = stats.get("deepening_rounds", 1)
        check(stats["partition_exchanges"] == rounds,
              f"the partitioned {label}: {stats['partition_exchanges']} "
              f"exchanges for {rounds} rounds")
        print(f"[part] {label}: {len(res)} results byte-identical to the "
              f"earlier phase's text; parts {stats['partition_parts']}, "
              f"imbalance {stats['partition_imbalance']}; "
              f"{meter.summary()}; exchanges {stats['partition_exchanges']} "
              f"({stats['partition_cross_bytes']} B) over {rounds} rounds; "
              f"wall {wall:.3f} s against unpartitioned {unpart} s; peak "
              f"{peak} B; card {card}", flush=True)
        return res, stats

    TT.TsrTorch._mine_restricted = tsr_round
    PN.mine_partitioned_slices = slices
    try:
        with meter:
            # Kosarak-shaped TSR at two parts on phase 9's vertical DB,
            # beside the unpartitioned engine on it
            vdb = inputs["kos_vdb"]
            eng = TT.TsrTorch(vdb, 100, 0.5, max_side=2)
            meter.reset()
            t0 = time.perf_counter()
            one = eng.mine()
            torch.cuda.synchronize()
            one_s = time.perf_counter() - t0
            one_b2 = meter.launches()["b2"]
            check(digest(rules_text(one)) == want["tsr"],
                  "the unpartitioned TSR engine on phase 9's DB differs")
            orch = TT.TsrPartitioned(vdb, 100, 0.5, parts=PARTITION_PARTS,
                                     max_side=2)
            _, st = measured(
                "kosarak_like TSR k=100 max_side=2",
                lambda: (orch.mine(), orch.stats), want["tsr"], rules_text,
                round(one_s, 3), "b2")
            print(f"[part] kosarak_like TSR: evaluated {st['evaluated']} "
                  f"partitioned against {eng.stats['evaluated']} "
                  f"unpartitioned (ratio "
                  f"{st['evaluated'] / eng.stats['evaluated']:.3f}); B2 "
                  f"launches {meter.launches()['b2']} partitioned against "
                  f"{one_b2} unpartitioned", flush=True)
            del eng, orch, one
            # the 1 % TSR, max_side=None: resident rows
            db = inputs["tsr_small_db"]
            t0 = time.perf_counter()
            one = rules_text(TT.mine_tsr_torch(db, 100, 0.5, max_side=None))
            torch.cuda.synchronize()
            one_s = time.perf_counter() - t0
            check(digest(one) == want["tsr 1%"], "the 1 % TSR mine differs")

            def small():
                st: dict = {}
                res = TT.mine_tsr_torch(db, 100, 0.5, max_side=None,
                                        partition_parts=PARTITION_PARTS,
                                        stats_out=st)
                return res, st
            _, st = measured("kosarak_like(scale=0.01) TSR max_side=None",
                             small, want["tsr 1%"], rules_text,
                             round(one_s, 3), "b2")
            check(st.get("resident_rounds", 0)
                  == PARTITION_PARTS * st["deepening_rounds"],
                  f"the 1 % partitioned TSR's slices took the resident "
                  f"route {st.get('resident_rounds', 0)} times")
            print(f"[part] kosarak_like(scale=0.01) TSR: resident rounds "
                  f"{st['resident_rounds']}, waves {st['resident_waves']}, "
                  f"evaluated {st['evaluated']}", flush=True)
            # BMS SPADE through the queue slices and the classic ones
            bms, bms_minsup = inputs["bms"]
            for fused in ("auto", "never"):
                def spade(fused=fused):
                    st: dict = {}
                    res = mine_spade_torch(bms, bms_minsup, fused=fused,
                                           partition_parts=PARTITION_PARTS,
                                           stats_out=st)
                    return res, st
                measured(f"bms_webview2_like SPADE fused={fused!r}", spade,
                         want[f"spade {fused}"], patterns_text,
                         single_walls[f"spade {fused}"], "b1")
            # MSNBC SPAM: B3 on each slice
            msnbc, msnbc_minsup = inputs["msnbc"]

            def spam():
                st: dict = {}
                res = mine_spam_torch(msnbc, msnbc_minsup,
                                      partition_parts=PARTITION_PARTS,
                                      stats_out=st)
                return res, st
            measured("msnbc_like SPAM", spam, want["spam"], patterns_text,
                     single_walls["spam"], "b3")
            # Gazelle cSPADE: no hand kernel on this route
            gz, gz_minsup = inputs["gazelle"]
            meter.reset()
            t0 = time.perf_counter()
            cs: dict = {}
            got = mine_cspade_torch(gz, gz_minsup, maxgap=2, maxwindow=5,
                                    partition_parts=PARTITION_PARTS,
                                    stats_out=cs)
            torch.cuda.synchronize()
            cs_s = time.perf_counter() - t0
            check(digest(patterns_text(got)) == want["cspade"],
                  "the partitioned cSPADE mine differs from phase 16's")
            check(cs["partition_exchanges"] == 1, "cSPADE exchanges")
            print(f"[part] gazelle_like cSPADE: {len(got)} patterns "
                  f"byte-identical to phase 16's text; imbalance "
                  f"{cs['partition_imbalance']}; {meter.summary()}; wall "
                  f"{cs_s:.3f} s against unpartitioned "
                  f"{single_walls['cspade']} s", flush=True)
            # a composite checkpoint of the BMS mine, resumed mid-slice
            store = CompositeStore()
            meter.reset()
            got = mine_spade_torch(bms, bms_minsup,
                                   partition_parts=PARTITION_PARTS,
                                   checkpoint=store)
            check(digest(patterns_text(got)) == want["spade auto"],
                  "the checkpointed partitioned SPADE mine differs")
            mids = [st for st in store.saved
                    if st["partition"]["active_part"] is not None
                    and st["partition"]["active_state"]["stack"]]
            check(bool(mids), "no composite was saved mid-slice")
            mid = mids[len(mids) // 2]
            t0 = time.perf_counter()
            got = mine_spade_torch(bms, bms_minsup,
                                   partition_parts=PARTITION_PARTS,
                                   checkpoint=CompositeStore(mid, 1e9))
            torch.cuda.synchronize()
            resume_s = time.perf_counter() - t0
            check(digest(patterns_text(got)) == want["spade auto"],
                  "the resumed partitioned SPADE mine differs")
            print(f"[part] bms_webview2_like SPADE checkpointed: "
                  f"{len(store.saved)} composites, {len(mids)} mid-slice; "
                  f"composite {store.saved.index(mid)} (part "
                  f"{mid['partition']['active_part']}, "
                  f"{len(mid['partition']['active_state']['stack'])} live "
                  f"nodes, {len(mid['results'])} done rows) resumed "
                  f"byte-identical in {resume_s:.3f} s", flush=True)
    finally:
        TT.TsrTorch._mine_restricted = orig_round
        PN.mine_partitioned_slices = orig_slices
    print(f"[part] phase {time.perf_counter() - t_phase:.1f} s; launches "
          f"on the partitioned path {launched}; tallies {PN.tallies()}",
          flush=True)
    return launched


def start_child(script: str, *args) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, "-c", script, *map(str, args)],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, text=True)


# cSPADE's copied CPU oracle on the Gazelle-shaped database at a scale,
# run in a child process: its wall first, then the canonical text
CSPADE_ORACLE = r"""
import sys, time
from spark_fsm_tpu_torch.data.synth import gazelle_like
from spark_fsm_tpu_torch.data.vertical import abs_minsup
from spark_fsm_tpu_torch.models.oracle import mine_cspade
from spark_fsm_tpu_torch.utils.canonical import patterns_text
db = gazelle_like(scale=float(sys.argv[1]), fast=True)
t0 = time.perf_counter()
res = mine_cspade(db, abs_minsup(0.005, len(db)), maxgap=2, maxwindow=5)
print(f"{time.perf_counter() - t0:.3f}")
print(patterns_text(res), end="")
"""
GAZELLE_SCALES = (1.0, 0.1)
# the copied CPU oracle of phases 5 and 13 (SPADE on the BMS-WebView-2-
# and the MSNBC-shaped databases at their minsup), in child processes
# started at the top: the wall first, then the canonical text
SPADE_ORACLE = r"""
import sys, time
from spark_fsm_tpu_torch.data.synth import bms_webview2_like, msnbc_like
from spark_fsm_tpu_torch.data.vertical import abs_minsup
from spark_fsm_tpu_torch.models.oracle import mine_spade
from spark_fsm_tpu_torch.utils.canonical import patterns_text
db = (bms_webview2_like() if sys.argv[1] == "bms"
      else msnbc_like(scale=1.0, fast=True))
t0 = time.perf_counter()
res = mine_spade(db, abs_minsup(float(sys.argv[2]), len(db)))
print(f"{time.perf_counter() - t0:.3f}")
print(patterns_text(res), end="")
"""
SPADE_ORACLES = (("bms", 0.001), ("msnbc", 0.005))


def collect_oracle(proc: subprocess.Popen, what: str):
    """An oracle child's (seconds, patterns text); fails if it failed."""
    out, _ = proc.communicate(timeout=900)
    check(proc.returncode == 0,
          f"the {what} oracle process exited with {proc.returncode}")
    secs, text = out.split("\n", 1)
    return float(secs), text


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def rand_words(rng, *shape) -> np.ndarray:
    """Sparse-ish uint32 words, with bit 31 forced on in a tenth of them."""
    w = (rng.integers(0, 2**32, shape, dtype=np.uint32)
         & rng.integers(0, 2**32, shape, dtype=np.uint32)
         & rng.integers(0, 2**32, shape, dtype=np.uint32))
    top = rng.random(shape) < 0.1
    return w | (top.astype(np.uint32) << np.uint32(31))


def pair_bound_ms(P: int, NI: int, S: int, W: int):
    """Least time for one pair-support launch: each operand row read once
    and the output written once, against the fewest integer operations the
    function needs per pair and sequence: one three-input logic op per word
    (AND folded into the running OR, the last one also setting the nonzero
    predicate) and one predicated add, W + 1 in all."""
    nbytes = (P + NI) * S * W * 4 + P * NI * 4
    ops = P * NI * S * (W + 1)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def extend_bound_ms(P: int, NI: int, S: int, W: int, n_live: int = None):
    """Least time for one extension-count-prune launch: the pair-support
    bound over the live item rows (each read once, W + 1 operations per
    live pair and sequence) with the [P, NI] counts and the [P, NI/32] mask
    words written once.  ``n_live`` (default NI) is how many leading item
    rows can be nonzero; the rest are known zero and need no work."""
    n_live = NI if n_live is None else n_live
    nbytes = (P + n_live) * S * W * 4 + P * NI * 4 + P * (NI // 32) * 4
    ops = P * n_live * S * (W + 1)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def rule_ops_per_seq(km: int, W: int) -> int:
    """Fewest int32 operations one candidate needs per sequence.  A
    three-input LOP3 combines three words (n words take ceil((n-1)/2) of
    them) and can set the nonzero predicate of its result in the same
    instruction (the compiled body has LOP3s that write a register and a
    predicate at once).  One word: the X fold, whose last LOP3 also tests
    A (a lone test when km = 1); one shift; the Y fold ANDed with the
    shifted A, km + 1 words, whose last LOP3 tests sup; two predicated
    adds.  W words: each word's X fold; the W A-words ORed, the last LOP3
    testing A; a funnel shift a word; the first word's Y fold with the
    shifted A, and each later word's with the shifted A and the running
    hit (km + 2 words), the last LOP3 testing sup; two predicated adds."""
    def lop3s(n: int) -> int:
        return -(-(n - 1) // 2)

    if W == 1:
        return max(1, lop3s(km)) + 1 + lop3s(km + 1) + 2
    x = W * lop3s(km) + lop3s(W)
    y = lop3s(km + 1) + (W - 1) * lop3s(km + 2)
    return x + W + y + 2


def rule_rows(xy) -> int:
    """Store rows one rule-support launch must read: the distinct prefix
    rows its X slots name plus the distinct suffix rows its Y slots name.
    An unused (-1) slot reads the all-ones pad row, which needs no read."""
    import torch

    return sum(int(torch.unique(xy[:, side][xy[:, side] >= 0]).numel())
               for side in (0, 1))


def rule_bound_ms(xy, S: int, W: int):
    """Least time for one rule-support launch on the candidates ``xy``
    [C, 2, km]: the ``rule_rows`` store rows read once, the candidates
    read and the [2, C] counts written once, against ``rule_ops_per_seq``
    operations per candidate and sequence."""
    C, _, km = xy.shape
    nbytes = rule_rows(xy) * S * W * 4 + C * 2 * km * 4 + 2 * C * 4
    ops = C * S * rule_ops_per_seq(km, W)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def rule_operands(dev, seed: int, C: int, km: int, M: int, S: int, W: int):
    """Seeded device operands of one rule-support launch: prefix/suffix
    stores [M+1, S*W] with the all-ones pad row M, and [C, 2, km]
    candidates of 1..km distinct rows a side (-1 in the unused slots)."""
    import torch

    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def store():
        w = torch.randint(-2**31, 2**31 - 1, (M + 1, S * W), dtype=torch.int32,
                          device=dev, generator=g)
        for _ in range(2):
            w &= torch.randint(-2**31, 2**31 - 1, w.shape, dtype=torch.int32,
                               device=dev, generator=g)
        w[M] = -1
        return w

    rng = np.random.default_rng(seed)
    xy = np.full((C, 2, km), -1, np.int32)
    sizes = rng.integers(1, km + 1, (C, 2))
    for c in range(C):
        picks = rng.choice(M, sizes[c].sum(), replace=False)
        xy[c, 0, :sizes[c, 0]] = picks[:sizes[c, 0]]
        xy[c, 1, :sizes[c, 1]] = picks[sizes[c, 0]:]
    return store(), store(), torch.from_numpy(xy).to(dev)


def recount_rules(vdb, rules):
    """Every rule's (sup, supx) recounted on the host from the token table,
    by first and last positions per sequence: X => Y holds in a sequence
    iff max over x of first(x) < min over y of last(y).  Independent of
    the bitmaps, the prep and both evaluators."""
    S = vdb.n_sequences
    pos = vdb.tok_word.astype(np.int64) * 32 + np.log2(
        vdb.tok_mask.astype(np.float64)).astype(np.int64)
    starts = np.searchsorted(vdb.tok_item, np.arange(vdb.n_items + 1))
    first, last = {}, {}
    for item in {i for x, y, _, _ in rules for i in x + y}:
        k = int(np.searchsorted(vdb.item_ids, item))
        lo, hi = starts[k], starts[k + 1]
        seq, p = vdb.tok_seq[lo:hi], pos[lo:hi]   # sorted by (seq, pos)
        useq, fi = np.unique(seq, return_index=True)
        li = np.append(fi[1:], len(seq)) - 1      # each run's last token
        f = np.full(S, np.iinfo(np.int64).max)
        f[useq] = p[fi]
        lst = np.full(S, -1)
        lst[useq] = p[li]
        first[item], last[item] = f, lst
    out = []
    for x, y, _, _ in rules:
        fx = np.max([first[i] for i in x], axis=0)
        ly = np.min([last[j] for j in y], axis=0)
        has_x = fx < np.iinfo(np.int64).max
        out.append((x, y, int(np.count_nonzero(has_x & (fx < ly))),
                    int(np.count_nonzero(has_x))))
    return out


def ptxas_usage(log: str) -> list:
    """One entry per compiled kernel from a ``-Xptxas -v`` build log: its
    template arguments, registers and spills."""
    out, name = [], "?"
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '\w*?\d([a-z_]+_kernel)I(\w*?)EEv",
                      ln)
        if m:
            name = f"{m.group(1)}<{','.join(re.findall(r'L[ib](\d+)E', m.group(2) + 'E'))}>"
        elif "spill stores" in ln:
            spill = ln.strip()
        elif "Used" in ln and "registers" in ln:
            regs = re.search(r"Used (\d+) registers", ln).group(1)
            out.append(f"{name}: {regs} registers, {spill}")
    return out


class SnapshotStore:
    """A checkpoint for ``mine_spade_torch``: nothing to resume, a
    snapshot at every chance (``every_s`` 0), every delta kept."""

    every_s = 0.0

    def __init__(self):
        self.saved = []

    def load(self):
        return None

    def save(self, state):
        self.saved.append(state)

    def merged(self, k: int) -> dict:
        """Snapshot ``k`` with every earlier delta's results merged in, as
        a checkpoint store hands it back."""
        snap = json.loads(json.dumps(self.saved[k]))
        snap["results"] = [r for s in self.saved[:k + 1] for r in s["results"]]
        snap["results_done"] = 0
        return snap


def tokenizer_times(name: str, db, minsup: int, sample: int = 1):
    """``build_vertical``'s wall with the native tokenizer, and both
    tokenizers on the first ``1/sample`` of the database, whose builds
    must agree.  Returns the full build."""
    from spark_fsm_tpu_torch.data import fasttok
    from spark_fsm_tpu_torch.data import vertical as V

    t0 = time.perf_counter()
    full = V.build_vertical(db, min_item_support=minsup)
    first_s = time.perf_counter() - t0
    part = db if sample == 1 else db[:len(db) // sample]
    t0 = time.perf_counter()
    a = full if sample == 1 else V.build_vertical(part,
                                                  min_item_support=minsup)
    part_s = first_s if sample == 1 else time.perf_counter() - t0
    saved = V.tokenize
    V.tokenize = fasttok.flatten_numpy
    try:
        t0 = time.perf_counter()
        b = V.build_vertical(part, min_item_support=minsup)
        numpy_s = time.perf_counter() - t0
    finally:
        V.tokenize = saved
    for f in ("item_ids", "seq_lengths", "item_supports", "tok_item",
              "tok_seq", "tok_word", "tok_mask"):
        check(np.array_equal(getattr(a, f), getattr(b, f)),
              f"{name}: the two tokenizers' vertical builds differ in {f}")
    print(f"[tok] {name}: build_vertical with the {fasttok.backend()} "
          f"tokenizer {first_s:.3f} s ({len(db)} sequences, "
          f"min_item_support {minsup}); on {len(part)} of them "
          f"{part_s:.3f} s against the numpy flatten's {numpy_s:.3f} s, "
          f"equal builds", flush=True)
    return full


def time_ms(fn, warmup: int, reps: int) -> float:
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def launch_ms(fn, warmup: int, n: int) -> float:
    """Device time per launch of a short kernel: CUDA events around n
    back-to-back calls queued behind a spinning kernel of about 0.1 s, so
    the wrapper's host work is done before the first of them runs and
    no gap between launches is counted."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda._sleep(200_000_000)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def predict_phase(torch, dev, rule_sets) -> None:
    """Phase 20: each rule set through the artifact cache at the
    ``[predict]`` defaults, its prefixes scored in waves of each width
    against ``predict_host``, timed, and sent through the broker."""
    from spark_fsm_tpu_torch.ops import extend_prune as EP
    from spark_fsm_tpu_torch.ops import pair_support as PS
    from spark_fsm_tpu_torch.ops import rule_support as RS
    from spark_fsm_tpu_torch.ops import rule_trie as RT
    from spark_fsm_tpu_torch.profile_mine import (
        PREDICT_M, PREDICT_WAVES, depth_groups, timed_wave, wave_summary)
    from spark_fsm_tpu_torch.service import model as SM
    from spark_fsm_tpu_torch.service import predictor as PR

    PR.configure({})   # the [predict] defaults
    cfg = dict(PR._cfg)
    t_phase = time.perf_counter()
    PS.pair_supports.launches = 0
    RS.rule_supports.launches = 0
    EP.extend_count_prune.launches = 0
    for name, kind, payload, prefixes in rule_sets:
        rules = (RT.rules_from_patterns(SM.deserialize_patterns(payload))
                 if kind == "patterns" else SM.deserialize_rules(payload))
        digest = RT.rules_digest(payload)
        want = [json.dumps(RT.predict_host(rules, p, PREDICT_M),
                           sort_keys=True) for p in prefixes]
        groups = depth_groups(prefixes, cfg["depth_floor"])
        tries = {d: PR._cache(dev).get_or_build(digest, d, lambda: rules,
                                                cfg["lanes_floor"])
                 for d in groups}

        def same(part, rows):
            return [prefixes[i] for i, r in zip(part, rows)
                    if json.dumps(r, sort_keys=True) != want[i]]

        # every row through score_wave, in waves of each width
        for W in PREDICT_WAVES:
            for d, idx in groups.items():
                for k in range(0, len(idx), W):
                    part = idx[k:k + W]
                    bad = same(part, RT.score_wave(
                        tries[d], [prefixes[i] for i in part], PREDICT_M))
                    check(not bad, f"{name}: score_wave at W={W} D={d} "
                          f"differs from predict_host at prefix {bad[:1]}")
        # the stages timed at the depth floor's artifact (the bulk)
        depth, idx = next(iter(groups.items()))
        trie = tries[depth]
        timing = {}
        for W in PREDICT_WAVES:
            timed_wave(trie, [prefixes[i] for i in idx[:W]], PREDICT_M)
            recs = []
            for k in range(0, len(idx), W):
                part = idx[k:k + W]
                rows, rec = timed_wave(trie, [prefixes[i] for i in part],
                                       PREDICT_M)
                check(not same(part, rows), f"{name}: the timed wave differs")
                recs.append(rec)
            timing[W] = wave_summary(recs)
        # the widest wave's peak on the deepest artifact
        deep_d = max(tries)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        RT.score_wave(tries[deep_d], [prefixes[i] for i in groups[deep_d][:64]],
                      PREDICT_M, wave_pad=64)
        torch.cuda.synchronize()
        wave_peak = torch.cuda.max_memory_allocated() - base
        stages = "; ".join(
            f"W={W}: device {t['device_ms']['median']:.4f} / "
            f"{t['device_ms']['p99']:.4f} ms, wall "
            f"{1e3 * t['wall_s']['median']:.4f} / "
            f"{1e3 * t['wall_s']['p99']:.4f} ms (pack "
            f"{1e3 * t['pack_s']['median']:.4f}, score "
            f"{1e3 * t['score_s']['median']:.4f}, decode "
            f"{1e3 * t['decode_s']['median']:.4f} ms)"
            for W, t in timing.items())
        print(f"[predict] {name}: {len(rules)} rules, lanes {trie.lanes}, F "
              f"{trie.F}, D {sorted(tries)} (prefixes a depth "
              f"{ {d: len(v) for d, v in groups.items()} }), nbytes "
              f"{ {d: t.nbytes() for d, t in tries.items()} }; "
              f"{len(prefixes)} prefixes byte-identical to predict_host at "
              f"W = {', '.join(map(str, PREDICT_WAVES))}, m = {PREDICT_M}; "
              f"at D={depth}, median / p99: {stages}; widest wave (W=64, "
              f"D={deep_d}) peak {wave_peak} B over {base} B allocated",
              flush=True)

        # the broker: clients in threads, the window on
        broker = PR.PredictBroker()
        before = dict(PR._stats)
        reqs = [idx[r % len(idx)] for r in range(PREDICT_REQUESTS)]
        tickets, errors = [None] * len(reqs), []

        def client(c):
            try:
                for r in range(c, len(reqs), PREDICT_THREADS):
                    tickets[r] = broker.submit(trie, prefixes[reqs[r]],
                                               PREDICT_M, "normal",
                                               tag=f"client{c}")
            except Exception as exc:   # reported by the check below
                errors.append(repr(exc))

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(PREDICT_THREADS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        broker_s = time.perf_counter() - t0
        broker.shutdown()
        check(not errors, f"{name}: broker clients failed: {errors[:2]}")
        check(all(json.dumps(t.entries, sort_keys=True) == want[i]
                  for t, i in zip(tickets, reqs)),
              f"{name}: a broker answer differs from predict_host")
        d = {k: PR._stats[k] - before[k]
             for k in ("waves", "fused_waves", "fused_jobs", "solo_jobs")}
        share = d["fused_jobs"] / (d["fused_jobs"] + d["solo_jobs"])
        check(share > 0, f"{name}: no request rode a fused wave: {d}")
        waits = sorted(1e3 * (t.dispatch_t - t.submit_t) for t in tickets)
        print(f"[predict] {name} broker: {len(reqs)} requests from "
              f"{PREDICT_THREADS} threads, window {cfg['window_ms']} ms, "
              f"max_wave {cfg['max_wave']}: {d['waves']} waves "
              f"({d['fused_waves']} fused), fused share {share:.4f}, "
              f"{broker_s:.4f} s ({len(reqs) / broker_s:.1f} requests/s), "
              f"window wait median {statistics.median(waits):.4f} ms, "
              f"answers equal predict_host", flush=True)
    launched = (PS.pair_supports.launches, RS.rule_supports.launches,
                EP.extend_count_prune.launches)
    check(launched == (0, 0, 0),
          f"the prediction path launched a hand kernel: {launched}")
    print(f"[predict] B1, B2, B3 launches on the path {launched}; phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)


def _http(port: int, endpoint: str, **params) -> dict:
    import urllib.parse
    import urllib.request

    url = f"http://127.0.0.1:{port}{endpoint}"
    data = urllib.parse.urlencode(params).encode()
    with urllib.request.urlopen(url, data=data, timeout=600) as resp:
        return json.loads(resp.read().decode())


def service_phase(torch, card: str, jobs: list, predict_sets: dict) -> None:
    """Phase 23: the port's service on the card, over HTTP.  ``jobs``:
    ``(name, db, params, get kind, the library result's serialization,
    the library walls (cold, warm), the kernel whose launches must rise or
    None for cSPADE, whose engine runs torch ops only)`` in the order they
    are sent; a ``None`` serialization repeats the previous job, which the
    engine cache must answer."""
    from spark_fsm_tpu_torch.ops import extend_prune as EP
    from spark_fsm_tpu_torch.ops import pair_support as PS
    from spark_fsm_tpu_torch.ops import rule_support as RS
    from spark_fsm_tpu_torch.ops.rule_trie import (predict_host,
                                                   rules_from_patterns)
    from spark_fsm_tpu_torch.service import model as SM
    from spark_fsm_tpu_torch.service import sources
    from spark_fsm_tpu_torch.service.app import serve_background

    counters = {"b1": PS.pair_supports, "b2": RS.rule_supports,
                "b3": EP.extend_count_prune}
    dbs = {name: db for name, db, *_ in jobs}
    sources.register("SMOKE", lambda req, store: dbs[req.param("db")])
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    srv = serve_background()   # no device given: the service takes cuda
    port = srv.server_port
    job_launches = {}
    try:
        payloads = {}
        for i, (name, db, params, get, want, lib_walls, kernel) in \
                enumerate(jobs):
            uid = f"smoke-{i}-{name}"
            for fn in counters.values():
                fn.launches = 0
            t0 = time.perf_counter()
            r = _http(port, "/train", uid=uid, source="SMOKE", db=name,
                      **params)
            check(r["status"] == "started", f"/train {name}: {r}")
            while True:
                st = _http(port, f"/status/{uid}")
                if st["status"] in ("finished", "failure"):
                    break
                time.sleep(0.005)
            wall_s = time.perf_counter() - t0
            check(st["status"] == "finished",
                  f"service job {name} failed: {st['data'].get('error')}")
            launches = {k: fn.launches for k, fn in counters.items()}
            job_launches.setdefault(name, launches)
            stats = json.loads(st["data"]["stats"])
            body = _http(port, f"/get/{get}", uid=uid)["data"][get]
            if want is None:   # the repeat: the cache answers it
                want = payloads[name]
                check(stats.get("store_cache_hit") is True,
                      f"the repeat {name} request missed the engine cache")
            check(digest(body) == digest(want),
                  f"/get/{get} of {name} differs from the library result "
                  f"by SHA-256")
            payloads[name] = body
            check(kernel is None or launches[kernel] > 0,
                  f"the {name} job launched {kernel} 0 times: {launches}")
            print(f"[service] {name} {params}: status finished, {get} body "
                  f"SHA-256 {digest(body)[:16]} == library result's; "
                  f"submit-to-finished {wall_s:.3f} s (job mine_s "
                  f"{stats.get('mine_s')}, dataset_s "
                  f"{stats.get('dataset_s')}), library cold/warm "
                  f"{lib_walls} s; route fused={stats.get('fused')!r} "
                  f"resident={stats.get('resident')!r} store_cache_hit="
                  f"{stats.get('store_cache_hit')!r}; launches {launches}; "
                  f"card {card}", flush=True)
        for name, (what, kind, payload, prefixes) in predict_sets.items():
            uid = next(f"smoke-{i}-{n}" for i, (n, *_r) in enumerate(jobs)
                       if n == name)
            rules = (SM.deserialize_rules(payload) if kind == "rules"
                     else rules_from_patterns(SM.deserialize_patterns(payload)))
            lat = []
            for prefix in prefixes:
                t0 = time.perf_counter()
                r = _http(port, "/predict", uid=uid,
                          items=",".join(map(str, prefix)), m="8")
                lat.append(time.perf_counter() - t0)
                check(r["status"] == "finished", f"/predict {name}: {r}")
                got = json.loads(r["data"]["predictions"])
                check(got == predict_host(rules, prefix, 8),
                      f"/predict on {name} differs from predict_host at "
                      f"prefix {prefix}")
            lat_ms = sorted(1e3 * x for x in lat)
            print(f"[service] /predict {what}: {len(prefixes)} prefixes "
                  f"equal to predict_host (m=8); latency median "
                  f"{statistics.median(lat_ms):.3f} ms, first (artifact "
                  f"build) {1e3 * lat[0]:.3f} ms, max {lat_ms[-1]:.3f} ms; "
                  f"card {card}", flush=True)
        admin = _http(port, "/admin/stats")
        check(admin["backend"] == "cuda" and admin["devices"] >= 1,
              f"/admin/stats reports {admin['backend']!r} x{admin['devices']}")
        check(admin["store_cache"]["hits"] >= 1,
              f"/admin/stats store_cache {admin['store_cache']}")
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        print(f"[service] /admin/stats backend {admin['backend']!r} devices "
              f"{admin['devices']}, store_cache {admin['store_cache']}, "
              f"jobs {admin['jobs']}; max_memory_allocated {peak} B; phase "
              f"{time.perf_counter() - t_phase:.1f} s; card {card}",
              flush=True)
    finally:
        srv.master.shutdown()
        srv.shutdown()
        srv.server_close()
        sources.SOURCES.pop("SMOKE", None)
    return job_launches


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _service_child(name: str, cfg: dict):
    """Boot ``spark_fsm_tpu_torch.service.app`` in a fresh process on the
    card with the boot config ``cfg``; returns (process, port, wall from
    start to the first answered ping, log path).  The prewarm, when the
    config enables it, runs before the server listens, so it is inside
    that wall."""
    import urllib.error

    port = _free_port()
    run_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "smoke")
    os.makedirs(run_dir, exist_ok=True)
    cfg_path = os.path.join(run_dir, f"{name}.json")
    log_path = os.path.join(run_dir, f"{name}.log")
    with open(cfg_path, "w") as fh:
        json.dump(cfg, fh)
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "spark_fsm_tpu_torch.service.app",
             "--config", cfg_path, "--device", "cuda", "--port", str(port)],
            stdout=log, stderr=subprocess.STDOUT,
            cwd=os.path.dirname(os.path.abspath(__file__)))
    while True:
        try:
            _http(port, "/admin/ping")
            return proc, port, time.perf_counter() - t0, log_path
        except (urllib.error.URLError, ConnectionError, OSError):
            if proc.poll() is not None or time.perf_counter() - t0 > 600:
                proc.kill()
                with open(log_path) as fh:
                    raise RuntimeError(f"service child {name} never answered:"
                                       f"\n{fh.read()[-3000:]}")
            time.sleep(0.05)


def _train_wait(port: int, uid: str, **params) -> tuple:
    """Submit a /train, wait for it; returns (status body, wall s)."""
    t0 = time.perf_counter()
    r = _http(port, "/train", uid=uid, **params)
    check(r["status"] == "started", f"/train {uid}: {r}")
    while True:
        st = _http(port, f"/status/{uid}")
        if st["status"] in ("finished", "failure"):
            break
        time.sleep(0.005)
    wall = time.perf_counter() - t0
    check(st["status"] == "finished",
          f"{uid} failed: {st['data'].get('error')}")
    return st, wall


def warm_phase(torch, card: str, bms: tuple, small: tuple) -> None:
    """Phase 24 (a): a cold and a prewarmed service, each in a fresh
    process.  ``bms``/``small``: (database, /train params, the body's
    library serialization, its get kind, the prewarm envelope)."""
    from spark_fsm_tpu_torch.data.spmf import format_spmf

    inline = {name: format_spmf(job[0]) for name, job in
              (("bms", bms), ("small", small))}
    t_phase = time.perf_counter()
    for name, prewarmed in (("cold", False), ("prewarmed", True)):
        cfg = {"prewarm": dict(bms[4], enabled=True)} if prewarmed else {}
        proc, port, boot_s, log_path = _service_child(f"warm-{name}", cfg)
        try:
            line = [f"[warm] {name} child: boot (process start to the "
                    f"first answered ping) {boot_s:.3f} s"]
            enums = []

            def report(what: str, rep: dict) -> None:
                bad = [r for r in rep["keys"] if "error" in r]
                check(not bad, f"prewarm ({what}) rows with error: {bad}")
                kinds: dict = {}
                for r in rep["keys"]:
                    n, w = kinds.get(r["kind"], (0, 0.0))
                    kinds[r["kind"]] = (n + 1, round(w + r["wall_s"], 3))
                line.append(
                    f"prewarm ({what}) {len(rep['keys'])} keys in "
                    f"{rep['total_wall_s']} s, builds+first loads "
                    f"{sum(r['fresh_compiles'] for r in rep['keys'])} "
                    f"({round(sum(r['compile_s'] for r in rep['keys']), 3)}"
                    f" s), by kind (keys, wall s) {kinds}")
                enums.append(rep.get("enumerated") or _http(
                    port, "/admin/shapes")["enumerated"])
                tag = "boot" if what == "boot" else "admin"
                with open(os.path.join(os.path.dirname(os.path.abspath(
                        __file__)), "build", "smoke", f"prewarm_{tag}.json"),
                          "w") as fh:
                    json.dump(rep, fh, indent=1)

            if prewarmed:
                boot = _http(port, "/admin/stats")["prewarm"]
                check(boot is not None, "the boot prewarm left no report")
                report("boot", boot)
            for job_name, (db, params, want, get, _env) in (("bms", bms),
                                                          ("small", small)):
                if prewarmed and job_name == "small":
                    report("/admin/prewarm", _http(
                        port, "/admin/prewarm",
                        **{k: str(int(v)) for k, v in small[4].items()}))
                st, wall = _train_wait(port, f"{name}-{job_name}",
                                       source="INLINE",
                                       sequences=inline[job_name], **params)
                body = _http(port, f"/get/{get}",
                             uid=f"{name}-{job_name}")["data"][get]
                check(digest(body) == digest(want),
                      f"{name} child's {job_name} body differs from the "
                      f"library result by SHA-256")
                stats = json.loads(st["data"]["stats"])
                line.append(f"first {job_name} job {wall:.3f} s (mine_s "
                            f"{stats.get('mine_s')}, route fused="
                            f"{stats.get('fused')!r} resident="
                            f"{stats.get('resident')!r})")
                if prewarmed:
                    shp = _http(port, "/admin/shapes")
                    if job_name == "bms":
                        drift = shp["drift"]
                        check(shp["enumerated"] == enums[0],
                              "/admin/shapes lost the boot enumeration")
                    else:
                        known = set(enums[0]) | set(enums[1])
                        drift = sorted(k for k in shp["recorded"]
                                       if k not in known)
                    check(drift == [], f"drift after the {job_name} job: "
                          f"{drift}")
                    line.append(f"drift after it {drift}")
            print("; ".join(line) + f"; card {card}", flush=True)
        finally:
            proc.terminate()
            try:
                proc.wait(30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
    print(f"[warm] phase (a) {time.perf_counter() - t_phase:.1f} s; child "
          f"logs and the prewarm reports (prewarm_*.json) under "
          f"build/smoke/", flush=True)


def _fused_pair(torch, port: int, broker, uids: tuple, params: dict,
                want: str) -> tuple:
    """Two TSR /train jobs on the SMOKE source at once, their first waves
    held in the broker's window until both jobs have a wave pending;
    returns (release-to-both-finished wall, broker stats delta, cross-job
    launches of the registry, B2 launches)."""
    from spark_fsm_tpu_torch.ops import rule_support as RS
    from spark_fsm_tpu_torch.service import fusion as FZ

    def cross() -> float:
        return sum(v for _, key, v in FZ._LAUNCHES_TOTAL.samples()
                   if dict(key).get("cross_job") == "true")

    def pending_jobs() -> set:
        with broker._cond:
            return {w.uid for g in broker._groups.values() for w in g.waves}

    broker.hold()
    stats0, cross0 = dict(broker.stats), cross()
    for uid in uids:
        r = _http(port, "/train", uid=uid, source="SMOKE", algorithm="TSR_TPU",
                  **params)
        check(r["status"] == "started", f"/train {uid}: {r}")
    t_wait = time.perf_counter()
    while not set(uids) <= pending_jobs():
        check(time.perf_counter() - t_wait < 300,
              f"the jobs {uids} never had waves in one window")
        time.sleep(0.01)
    RS.rule_supports.launches = 0
    t0 = time.perf_counter()
    broker.release()
    for uid in uids:
        while _http(port, f"/status/{uid}")["status"] not in (
                "finished", "failure"):
            time.sleep(0.01)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    b2 = RS.rule_supports.launches
    for uid in uids:
        st = _http(port, f"/status/{uid}")
        check(st["status"] == "finished",
              f"{uid} failed: {st['data'].get('error')}")
        body = _http(port, "/get/rules", uid=uid)["data"]["rules"]
        check(digest(body) == digest(want),
              f"/get/rules of {uid} differs from the library result by "
              f"SHA-256")
    delta = {k: v - stats0.get(k, 0) for k, v in broker.stats.items()
             if v != stats0.get(k, 0)}
    return wall, delta, int(cross() - cross0), b2


def _b2_on(torch, p1, s1, rows: int, C: int, km: int, seed: int):
    """B2 against its plain version on a store, candidates over its first
    ``rows`` rows with unused (-1) slots; returns (max abs err, the
    candidates)."""
    from spark_fsm_tpu_torch.ops import rule_support as RS

    rng = np.random.default_rng(seed)
    xy = rng.integers(0, rows, size=(C, 2, km)).astype(np.int32)
    xy[rng.random(xy.shape) < 0.25] = -1
    xy[:, :, 0] = rng.integers(0, rows, size=(C, 2))
    xy_t = torch.from_numpy(xy).to(p1.device)
    got = RS.rule_supports(p1, s1, xy_t)
    want = RS.rule_supports_plain(p1, s1, xy_t)
    torch.cuda.synchronize()
    return int((got.long() - want.long()).abs().max()), xy_t


def fusion_phase(torch, card: str, kos_db, kos_vdb, kos_payload: str,
                 kos_digest: str, ms_db, ms_payload: str,
                 solo_launches: dict, headline: tuple) -> None:
    """Phase 24 (b) and (c).  ``kos_*``: phase 9's Kosarak-shaped database,
    vertical DB, library result's serialization and the SHA-256 of its
    rule text; ``ms_*``: phase 13's MSNBC-shaped database and its TSR
    library result (k=100, minconf 0.5, ``max_side=2``); ``headline``:
    (C, km) of phase 8's headline launch."""
    from spark_fsm_tpu_torch import config as TC
    from spark_fsm_tpu_torch.models.tsr import TsrTorch
    from spark_fsm_tpu_torch.ops import rule_support as RS
    from spark_fsm_tpu_torch.service import fusion as FZ
    from spark_fsm_tpu_torch.service import sources
    from spark_fsm_tpu_torch.service.app import make_server
    from spark_fsm_tpu_torch.utils import faults
    from spark_fsm_tpu_torch.utils.canonical import rules_text

    saved = TC.get_config()
    fuse = FZ._fuse_preps
    kept: list = []

    def keep_last(uniq, m_pad, total_m):
        out = fuse(uniq, m_pad, total_m)
        kept[:] = [out, total_m]
        return out

    t_phase = time.perf_counter()
    dbs = {"kosarak": kos_db, "msnbc": ms_db}
    TC.set_config(TC.parse_config({"fusion": {"enabled": True,
                                              "window_ms": 20.0}}))
    FZ._fuse_preps = keep_last
    sources.register("SMOKE", lambda req, store: dbs[req.param("db")])
    srv = make_server(0, miner_workers=2)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    C, km = headline
    try:
        b = FZ.broker()
        tsr = dict(k="100", minconf="0.5", max_side="2")
        # (b) the full-size pair: the cost model decides every group
        wall, delta, cross, b2 = _fused_pair(
            torch, srv.server_port, b, ("fuse-a", "fuse-b"),
            dict(tsr, db="kosarak"), kos_payload)
        print(f"[fusion] two kosarak_like TSR jobs at once (k=100, minconf "
              f"0.5, max_side=2), both bodies equal phase 9's library result "
              f"by SHA-256; release-to-both-finished {wall:.3f} s; broker "
              f"{delta}; cross-job launches {cross}; B2 launches {b2} "
              f"against the solo job's {solo_launches.get('b2')} in phase "
              f"23; card {card}", flush=True)
        # the MSNBC-shaped pair: 17 items, so a wave's candidates leave
        # its launches part-filled and the cost model fuses
        kept.clear()
        wall, delta, cross, b2 = _fused_pair(
            torch, srv.server_port, b, ("fuse-c", "fuse-d"),
            dict(tsr, db="msnbc"), ms_payload)
        check(cross > 0, "no cross-job launch in the MSNBC-shaped pair: "
              "fsm_fusion_launches_total{cross_job=\"true\"} did not rise")
        check(bool(kept), "the broker built no fused store")
        (pf, sf), total_m = kept
        err, _ = _b2_on(torch, pf, sf, total_m, C, km, 24)
        check(err == 0, f"B2 on the broker's fused store != plain (max abs "
              f"err {err})")
        print(f"[fusion] two msnbc_like TSR jobs at once (k=100, minconf "
              f"0.5, max_side=2), both bodies equal the library result by "
              f"SHA-256; release-to-both-finished {wall:.3f} s; broker "
              f"{delta}; cross-job launches {cross}; B2 launches {b2}; a "
              f"fused store the broker built (M={pf.shape[0] - 1}, "
              f"{total_m} real rows): B2 equal to plain at C={C} km={km} "
              f"(max abs err {err}); card {card}", flush=True)
        del pf, sf
        kept.clear()
        # (c) the OOM drill on a fused launch: the broker's first launch
        # runs out of memory and halves through the engine's ladder
        with faults.injected("device.oom", nth=1):
            wall, delta, cross, b2 = _fused_pair(
                torch, srv.server_port, b, ("fuse-e", "fuse-f"),
                dict(tsr, db="msnbc"), ms_payload)
        halved = [json.loads(srv.master.store.get(f"fsm:stats:{u}") or "{}")
                  .get("degraded_launches", 0) for u in ("fuse-e", "fuse-f")]
        check(cross > 0 and min(halved) >= 1,
              f"the OOM on the first fused launch halved no cross-job "
              f"launch: cross-job launches {cross}, degraded_launches "
              f"{halved}")
        print(f"[fusion] OOM drill on a fused launch: device.oom injected on "
              f"the broker's first launch of the msnbc_like pair; "
              f"degraded_launches {halved}, cross-job launches {cross}, both "
              f"bodies equal the library result by SHA-256; "
              f"release-to-both-finished {wall:.3f} s; broker {delta}; B2 "
              f"launches {b2}; card {card}", flush=True)
    finally:
        FZ._fuse_preps = fuse
        srv.master.shutdown()
        srv.shutdown()
        srv.server_close()
        sources.SOURCES.pop("SMOKE", None)
        TC.set_config(saved)
    torch.cuda.empty_cache()

    # a full-size fused store laid out as the broker lays one out (two
    # engines' first-round stores), B2 on it against the solo store
    engines = [TsrTorch(kos_vdb, 100, 0.5, max_side=2) for _ in range(2)]
    m = min(engines[0].item_cap, kos_vdb.n_items)
    preps = [e._prep(m) for e in engines]
    pf, sf = fuse(preps, 1 << (2 * m - 1).bit_length(), 2 * m)
    err, xy_t = _b2_on(torch, pf, sf, 2 * m, C, km, 25)
    check(err == 0, f"B2 on the full-size fused store != plain (max abs "
          f"err {err})")
    p1, s1 = preps[0]
    xy_solo = torch.where(xy_t >= 0, xy_t % m, -1).to(torch.int32)
    fused_ms = time_ms(lambda: RS.rule_supports(pf, sf, xy_t), 2, 10)
    solo_ms = time_ms(lambda: RS.rule_supports(p1, s1, xy_solo), 2, 10)
    M = pf.shape[0] - 1
    S = kos_vdb.n_sequences
    fbound, fby = rule_bound_ms(xy_t, S, 1)
    sbound, sby = rule_bound_ms(xy_solo, S, 1)
    print(f"[fusion] full-size fused store (two first-round stores, M={M}, "
          f"{2 * m} real rows): B2 equal to plain at C={C} km={km} (max abs "
          f"err {err}), {fused_ms:.4f} ms on the "
          f"{'staged' if M <= RS.staged_max_rows(km) else 'walk'} path "
          f"(bound {fbound:.4f} ms, {fby}) against {solo_ms:.4f} ms on one "
          f"job's store (M={m}, "
          f"{'staged' if m <= RS.staged_max_rows(km) else 'walk'} path; "
          f"bound {sbound:.4f} ms, {sby}), the same candidates folded onto "
          f"its rows; card {card}", flush=True)
    del engines, preps, pf, sf, p1, s1, xy_t, xy_solo
    torch.cuda.empty_cache()

    # (c) the OOM drill on the kernel path
    eng = TsrTorch(kos_vdb, 100, 0.5, max_side=2)
    t0 = time.perf_counter()
    with faults.injected("device.oom", nth=1):
        got_r = eng.mine()
    torch.cuda.synchronize()
    drill_s = time.perf_counter() - t0
    check(digest(rules_text(got_r)) == kos_digest,
          "the OOM drill's rules differ from phase 9's")
    check(eng.stats.get("degraded_launches", 0) >= 1,
          f"the injected OOM halved no launch: {eng.stats}")
    print(f"[fusion] OOM drill: device.oom injected on the first kernel "
          f"launch of the kosarak_like TSR mine; degraded_launches "
          f"{eng.stats['degraded_launches']}, rules byte-identical to phase "
          f"9's; {drill_s:.3f} s, B2 launches "
          f"{eng.stats['kernel_launches'] - eng.stats['deepening_rounds']}; "
          f"phase (b)+(c) {time.perf_counter() - t_phase:.1f} s; card {card}",
          flush=True)


def world_drill(mesh, plan: dict) -> dict:
    """Phase 25 (b)'s rank side (run by ``spawn_world``): a tenth of phase
    9's Kosarak-shaped TSR at two parts with an injected
    ``device.dispatch`` fault on rank 0's row, under a meshguard of the
    rank's own (``dead_after=1``)."""
    import torch

    from spark_fsm_tpu_torch.config import MeshguardConfig
    from spark_fsm_tpu_torch.data.synth import kosarak_like
    from spark_fsm_tpu_torch.models.tsr import mine_tsr_torch
    from spark_fsm_tpu_torch.ops import rule_support as RS
    from spark_fsm_tpu_torch.service import meshguard as MG
    from spark_fsm_tpu_torch.utils import faults
    from spark_fsm_tpu_torch.utils.canonical import rules_text

    db = kosarak_like(scale=MESH_KOSARAK_SCALE, fast=True)
    guard = MG.install(MeshguardConfig(enabled=True, dead_after=1))
    if mesh.rank == 0:
        faults.arm("device.dispatch", every=1, times=1, match="part0")
    try:
        RS.rule_supports.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(mesh.device)
        st: dict = {}
        t0 = time.perf_counter()
        res = mine_tsr_torch(db, 100, 0.5, max_side=2, mesh=mesh,
                             partition_parts=plan["parts"], stats_out=st)
        torch.cuda.synchronize()
        return {"digest": digest(rules_text(res)),
                "wall_s": time.perf_counter() - t0,
                "b2": RS.rule_supports.launches,
                "dead": sorted(guard.dead_rows()),
                "epoch": guard.current_epoch(),
                "exchanges": st["partition_exchanges"],
                "rounds": st["deepening_rounds"],
                "peak": torch.cuda.max_memory_allocated(mesh.device)}
    finally:
        faults.disarm()
        MG.reset()


def _adoption_one_process(torch, card: str, inp: dict) -> None:
    """Phase 25 (a): the partitioned TSR and SPADE mines in this process,
    healthy and with partition row 0 killed by an injected fault."""
    from spark_fsm_tpu_torch.config import MeshguardConfig
    from spark_fsm_tpu_torch.models.spade import mine_spade_torch
    from spark_fsm_tpu_torch.models.tsr import TsrPartitioned
    from spark_fsm_tpu_torch.ops import pair_support as PS
    from spark_fsm_tpu_torch.ops import rule_support as RS
    from spark_fsm_tpu_torch.service import meshguard as MG
    from spark_fsm_tpu_torch.utils import faults
    from spark_fsm_tpu_torch.utils.canonical import patterns_text, rules_text

    bms, bms_minsup = inp["bms"]

    def tsr():
        orch = TsrPartitioned(inp["kos_vdb"], 100, 0.5,
                              parts=PARTITION_PARTS, max_side=2)
        return rules_text(orch.mine()), orch.stats

    def spade():
        st: dict = {}
        res = mine_spade_torch(bms, bms_minsup,
                               partition_parts=PARTITION_PARTS, stats_out=st)
        return patterns_text(res), st

    # (label, mine, digest, kernel wrapper, its name, the fault's match):
    # TSR's fault sites name their part, the queue engine's do not, so
    # the SPADE drill fails the first dispatch, which is part 0's
    for label, mine, want, fn, name, arm, healthy in (
            ("kosarak_like TSR k=100 max_side=2", tsr, inp["tsr"],
             RS.rule_supports, "B2", {"match": "part0"},
             "kosarak_like TSR k=100 max_side=2"),
            ("bms_webview2_like SPADE minsup 0.1 %", spade, inp["spade"],
             PS.pair_supports, "B1", {},
             "bms_webview2_like SPADE fused='auto'")):
        guard = MG.install(MeshguardConfig(enabled=True, dead_after=1))
        faults.arm("device.dispatch", every=1, times=1, **arm)
        try:
            fn.launches = 0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            text, st = mine()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            dead, epoch = sorted(guard.dead_rows()), guard.current_epoch()
        finally:
            faults.disarm()
            MG.reset()
        check(digest(text) == want, f"the adopted partitioned {label} "
              "differs from the earlier phase's text")
        check(dead == [0] and epoch == 1,
              f"adopted {label}: dead rows {dead}, epoch {epoch}")
        per_part = {k: v for k, v in st.items()
                    if k.startswith("launches_part")}
        print(f"[meshguard] {label} at {PARTITION_PARTS} parts, row 0 "
              f"killed: byte-identical to the earlier phase's text; dead rows "
              f"{dead}, epoch {epoch}; exchanges {st['partition_exchanges']}; "
              f"{name} launches {fn.launches}"
              f"{' ' + str(per_part) if per_part else ''}; wall {wall:.3f} s "
              f"against the healthy partitioned mine's (phase 22) "
              f"{inp['part walls'].get(healthy, 'not measured')}; "
              f"max_memory_allocated {peak} B; card {card}", flush=True)


def _world_drill_phase(card: str, want: str, healthy) -> None:
    """Phase 25 (b), first half: the adoption drill in a 2-rank gloo world
    whose ranks share the card; ``want``: the one-device rules' digest;
    ``healthy``: phase 21's walls of the same world's healthy mine."""
    from spark_fsm_tpu_torch.parallel.launch import spawn_world

    t0 = time.perf_counter()
    res = spawn_world(world_drill, 2, "gloo", "cuda:0",
                      ({"parts": PARTITION_PARTS},), timeout_s=900,
                      threads=max(1, (os.cpu_count() or 1) // 2))
    world_s = time.perf_counter() - t0
    check(len({rec["digest"] for rec in res}) == 1,
          "the world's adopted TSR differs between the ranks")
    check(res[0]["digest"] == want,
          "the world's adopted TSR differs from the one-device mine")
    for rec in res:
        check(rec["dead"] == [0] and rec["epoch"] == 1,
              f"dead rows {rec['dead']}, epoch {rec['epoch']}")
        check(rec["exchanges"] == rec["rounds"] + 1,
              f"{rec['exchanges']} exchanges over {rec['rounds']} rounds")
    print(f"[world] gloo x2 on the card, kosarak_like(scale="
          f"{MESH_KOSARAK_SCALE}) TSR at {PARTITION_PARTS} parts, rank 0's "
          f"row killed: rules SHA-256 {res[0]['digest'][:16]} equal on both "
          f"ranks and to the one-device mine; dead rows {res[0]['dead']}, "
          f"epoch {res[0]['epoch']}; exchanges "
          f"{[rec['exchanges'] for rec in res]} over {res[0]['rounds']} "
          f"rounds; B2 launches {[rec['b2'] for rec in res]}; walls "
          f"{[round(rec['wall_s'], 3) for rec in res]} s against the healthy "
          f"mine's (phase 21) {healthy or 'not measured'}; peaks "
          f"{[rec['peak'] for rec in res]} B; card {card}", flush=True)
    print(f"[world] the drill's world {world_s:.1f} s (spawn included)",
          flush=True)


def _serve_world(card: str, inp: dict, texts: list) -> None:
    """Phase 25 (b), second half: a service booted with ``[engine]
    mesh_devices = 2`` through the launcher (two ranks sharing the card),
    the BMS SPADE and the tenth-of-Kosarak TSR as ``/train`` jobs and the
    stream's first pushes."""
    from spark_fsm_tpu_torch.data.spmf import format_spmf
    from spark_fsm_tpu_torch.models._common import auto_pool_bytes

    import torch

    run_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "smoke")
    os.makedirs(run_dir, exist_ok=True)
    files = {}
    for name, db in (("bms", inp["bms"][0]), ("kosarak", inp["tenth"][0])):
        files[name] = os.path.join(run_dir, f"{name}.spmf")
        with open(files[name], "w") as fh:
            fh.write(format_spmf(db))
    # co-located ranks split the one-device pool budget, as in phase 21
    pool = auto_pool_bytes(torch.device("cuda", 0)) // 2
    proc, port, boot_s, log_path = _service_child("mesh-world", {
        "engine": {"mesh_devices": 2, "pool_bytes": pool}})
    try:
        print(f"[world] service with [engine] mesh_devices = 2 booted "
              f"through the launcher in {boot_s:.3f} s (two ranks on the "
              f"card, gloo; rank 1 binds no port)", flush=True)
        for uid, params, get, want, lib_s in (
                ("world-bms", dict(algorithm="SPADE_TPU",
                                   support=str(inp["bms"][1]), source="FILE",
                                   path=files["bms"]),
                 "patterns", inp["spade payload"], inp["spade wall"]),
                ("world-kosarak", dict(algorithm="TSR_TPU", k="100",
                                       minconf="0.5", max_side="2",
                                       source="FILE",
                                       path=files["kosarak"]),
                 "rules", inp["tenth"][1], inp["tenth"][2])):
            st, wall = _train_wait(port, uid, **params)
            body = _http(port, f"/get/{get}", uid=uid)["data"][get]
            check(digest(body) == digest(want),
                  f"/get/{get} of {uid} differs from the library result")
            stats = json.loads(st["data"]["stats"])
            print(f"[world] {uid}: {get} body SHA-256 {digest(body)[:16]} == "
                  f"library result's; submit-to-finished {wall:.3f} s (mine_s "
                  f"{stats.get('mine_s')}) against the library's {lib_s} s; "
                  f"route fused={stats.get('fused')!r}; rank 0's kernel "
                  f"launches {stats.get('kernel_launches')}; card {card}",
                  flush=True)
        admin = _http(port, "/admin/stats")
        check(admin["mesh_devices"] == 2,
              f"/admin/stats mesh_devices {admin['mesh_devices']}")
        for push, text in enumerate(texts[:MESH_STREAM_PUSHES], 1):
            t0 = time.perf_counter()
            r = _http(port, "/stream/world", sequences=text,
                      support=str(STREAM_MINSUP),
                      max_batches=str(STREAM_KEEP), algorithm="SPADE_TPU")
            wall = time.perf_counter() - t0
            check(r["status"] == "finished", f"world push {push}: {r}")
            body = _http(port, "/get/patterns",
                         uid="stream:world")["data"]["patterns"]
            check(digest(body) == inp["stream"][push][0],
                  f"world push {push} differs from phase 17's")
            print(f"[world] stream push {push}: patterns SHA-256 "
                  f"{digest(body)[:16]} == phase 17's; push wall {wall:.3f} s "
                  f"over HTTP against the library's "
                  f"{inp['stream'][push][1]:.3f} s", flush=True)
        print(f"[world] /admin/stats mesh_devices {admin['mesh_devices']}, "
              f"devices {admin['devices']}, backend {admin['backend']!r}",
              flush=True)
    finally:
        proc.terminate()
        try:
            rc = proc.wait(timeout=120)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            rc = None
    with open(log_path) as fh:
        log = fh.read()
    check(rc == 0, f"the world service exited with {rc}:\n{log[-2000:]}")
    check("mesh: rank 0 of a world of 2 (gloo)" in log,
          f"the world service did not boot as rank 0:\n{log[-2000:]}")


def _stream_service(torch, card: str, inp: dict, texts: list) -> None:
    """Phase 25 (c): a service in this process booted as ``main`` boots
    one with ``[prewarm]`` at the stream's envelope, taking phase 17's
    stream over HTTP."""
    from spark_fsm_tpu_torch import config as TC
    from spark_fsm_tpu_torch.ops import pair_support as PS
    from spark_fsm_tpu_torch.service import meshcall, prewarm
    from spark_fsm_tpu_torch.service.app import serve_background
    from spark_fsm_tpu_torch.utils import shapes

    saved = TC.get_config()
    per = inp["stream batch"]
    cfg = TC.parse_config({"prewarm": {
        "enabled": True, "stream_batch_sequences": per,
        "stream_seq_floor": per, "stream_items": inp["stream items"]}})
    TC.set_config(cfg)
    shapes.reset_recorded()   # the fresh service's registry
    srv = None
    try:
        t0 = time.perf_counter()
        report = meshcall.prewarm(prewarm.spec_from_config(cfg.prewarm),
                                  TC.engine_kwargs(
                                      "pool_bytes", "node_batch",
                                      "pipeline_depth", "chunk",
                                      "recompute_chunk"))
        warm_s = time.perf_counter() - t0
        check(not [row for row in report["keys"] if row.get("error")],
              f"a prewarm row failed: {report['keys']}")
        srv = serve_background()
        print(f"[stream-service] boot prewarm at stream_batch_sequences = "
              f"stream_seq_floor = {per}, stream_items = "
              f"{inp['stream items']}: "
              f"{len(report['keys'])} keys in "
              f"{warm_s:.3f} s ({[row['shape_key'] for row in report['keys']]})",
              flush=True)
        walls, launches = [], []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for push, text in enumerate(texts, 1):
            PS.pair_supports.launches = 0
            t0 = time.perf_counter()
            r = _http(srv.server_port, "/stream/msnbc", sequences=text,
                      support=str(STREAM_MINSUP),
                      max_batches=str(STREAM_KEEP), algorithm="SPADE_TPU")
            walls.append(time.perf_counter() - t0)
            launches.append(PS.pair_supports.launches)
            check(r["status"] == "finished", f"stream push {push}: {r}")
            body = _http(srv.server_port, "/get/patterns",
                         uid="stream:msnbc")["data"]["patterns"]
            check(digest(body) == inp["stream"][push][0],
                  f"service push {push} differs from phase 17's")
            # the first push finds no tracked tree to sweep (phase 17)
            check((launches[-1] > 0) == (push > 1),
                  f"push {push} launched B1 {launches[-1]} times")
        peak = torch.cuda.max_memory_allocated()
        st = _http(srv.server_port, "/status/stream:msnbc")
        route = json.loads(st["data"]["stats"])["route"]
        check(route == "incremental", f"the stream took the {route!r} route")
        shp = _http(srv.server_port, "/admin/shapes")
        check(shp["drift"] == [], f"/admin/shapes drift {shp['drift']}")
        print(f"[stream-service] {len(texts)} pushes of {per} sequences over "
              f"HTTP, window {STREAM_KEEP}: route {route!r}, every push's "
              f"patterns SHA-256 == phase 17's; B1 launches a push (the "
              f"first has no tracked tree to sweep) "
              f"{launches}; push walls {[round(w, 3) for w in walls]} s "
              f"against the library's "
              f"{[round(inp['stream'][p][1], 3) for p in range(1, len(texts) + 1)]}"
              f" s; /admin/shapes drift {shp['drift']} over "
              f"{len(shp['recorded'])} recorded keys; max_memory_allocated "
              f"{peak} B; card {card}", flush=True)
    finally:
        if srv is not None:
            srv.master.shutdown()
            srv.shutdown()
            srv.server_close()
        TC.set_config(saved)


def mesh_service_phase(torch, card: str, inp: dict) -> None:
    """Phase 25: the service on a mesh.  ``inp``: phase 9's vertical DB
    (``kos_vdb``) and rules digest (``tsr``); phase 5's database and minsup
    (``bms``), its patterns digest (``spade``), serialization (``spade
    payload``) and wall (``spade wall``); the tenth of phase 9's database
    with its library serialization and wall (``tenth``); phase 17's
    batches' SPMF texts (``stream texts``), each push's serialization
    digest and wall (``stream``), the batch size and item count."""
    t_phase = time.perf_counter()
    texts = inp["stream texts"]
    _adoption_one_process(torch, card, inp)
    torch.cuda.empty_cache()
    _world_drill_phase(card, inp["tenth"][3], inp["world part tsr"])
    _serve_world(card, inp, texts)
    torch.cuda.empty_cache()
    _stream_service(torch, card, inp, texts)
    print(f"[meshguard] phase 25 {time.perf_counter() - t_phase:.1f} s; "
          f"card {card}", flush=True)


def phase25_only(torch) -> int:
    """``python3 chip_smoke.py --phase 25``: the card, then phase 25 on
    inputs made here through the library, where the full run hands it the
    earlier phases' results (the kernels build at their first launch)."""
    from spark_fsm_tpu_torch.data.spmf import format_spmf
    from spark_fsm_tpu_torch.data.synth import (
        bms_webview2_like, kosarak_like, msnbc_like)
    from spark_fsm_tpu_torch.data.vertical import abs_minsup, build_vertical
    from spark_fsm_tpu_torch.models.spade import mine_spade_torch
    from spark_fsm_tpu_torch.models.tsr import TsrTorch, mine_tsr_torch
    from spark_fsm_tpu_torch.service import model as SM
    from spark_fsm_tpu_torch.streaming import IncrementalWindowMiner
    from spark_fsm_tpu_torch.utils.canonical import patterns_text, rules_text

    card = smi("name,power.limit")
    print(f"[card] nvidia-smi: {card} | torch: "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}",
          flush=True)
    t0 = time.perf_counter()
    bms = bms_webview2_like()
    minsup = abs_minsup(0.001, len(bms))
    t1 = time.perf_counter()
    got = mine_spade_torch(bms, minsup)
    torch.cuda.synchronize()
    bms_s = round(time.perf_counter() - t1, 3)
    kos_vdb = build_vertical(kosarak_like(scale=1.0, fast=True),
                             min_item_support=1)
    rules = TsrTorch(kos_vdb, 100, 0.5, max_side=2).mine()
    tenth = kosarak_like(scale=MESH_KOSARAK_SCALE, fast=True)
    t1 = time.perf_counter()
    trules = mine_tsr_torch(tenth, 100, 0.5, max_side=2)
    torch.cuda.synchronize()
    tenth_s = round(time.perf_counter() - t1, 3)
    db = msnbc_like(scale=1.0, fast=True)
    per = len(db) // STREAM_PUSHES
    batches = [db[i * per:(i + 1) * per if i < STREAM_PUSHES - 1 else len(db)]
               for i in range(STREAM_PUSHES)]
    inc = IncrementalWindowMiner(STREAM_MINSUP, max_batches=STREAM_KEEP)
    served = {}
    for push, batch in enumerate(batches, 1):
        t1 = time.perf_counter()
        res = inc.push(batch)
        torch.cuda.synchronize()
        served[push] = (digest(SM.serialize_patterns(res)),
                        time.perf_counter() - t1)
    print(f"[phase 25 only] inputs through the library in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    mesh_service_phase(torch, card, {
        "kos_vdb": kos_vdb, "tsr": digest(rules_text(rules)),
        "bms": (bms, minsup), "spade": digest(patterns_text(got)),
        "spade payload": SM.serialize_patterns(got), "spade wall": (bms_s,),
        "tenth": (tenth, SM.serialize_rules(trules), tenth_s,
                  digest(rules_text(trules))),
        "part walls": {}, "world part tsr": None,
        "stream texts": [format_spmf(b) for b in batches],
        "stream": served, "stream batch": len(batches[0]),
        "stream items": len({i for seq in batches[0] for its in seq
                             for i in its})})
    print(f"card: {card}")
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    import spark_fsm_tpu_torch  # noqa: F401  (fails outside a checkout)

    if sys.argv[1:] == ["--phase", "25"]:
        return phase25_only(torch)

    oracles = {scale: start_child(CSPADE_ORACLE, scale)
               for scale in GAZELLE_SCALES}
    oracles.update({name: start_child(SPADE_ORACLE, name, rel)
                    for name, rel in SPADE_ORACLES})
    oracles.update({("stream", push): start_child(
        STREAM_ORACLE, push, STREAM_PUSHES, STREAM_KEEP, STREAM_MINSUP)
        for push in STREAM_ORACLE_PUSHES})
    try:
        return run(torch, oracles)
    finally:
        for proc in oracles.values():
            if proc.poll() is None:
                proc.kill()
            proc.wait()


def run(torch, oracles) -> int:
    from concurrent.futures import ThreadPoolExecutor

    from spark_fsm_tpu_torch.data import fasttok
    from spark_fsm_tpu_torch.data.spmf import format_spmf
    from spark_fsm_tpu_torch.data.synth import (
        bms_webview2_like, gazelle_like, kosarak_like, msnbc_like,
        synthetic_db)
    from spark_fsm_tpu_torch.data.vertical import (
        abs_minsup, build_vertical, dataset_stats)
    from spark_fsm_tpu_torch.models.oracle import mine_spade
    from spark_fsm_tpu_torch.models.spade import SpadeTorch, mine_spade_torch
    from spark_fsm_tpu_torch.models.spade_constrained import mine_cspade_torch
    from spark_fsm_tpu_torch.models.spade_queue import (
        queue_eligible, queue_geometry)
    from spark_fsm_tpu_torch.models.spam_bitmap import (
        mine_spam_torch, spam_geometry)
    from spark_fsm_tpu_torch.models._common import device_hbm_budget
    from spark_fsm_tpu_torch.models.tsr import (
        TsrTorch, mine_tsr_cpu, mine_tsr_torch)
    from spark_fsm_tpu_torch.ops import _build
    from spark_fsm_tpu_torch.ops import extend_prune as EP
    from spark_fsm_tpu_torch.ops import pair_support as PS
    from spark_fsm_tpu_torch.ops import ragged_batch as RB
    from spark_fsm_tpu_torch.ops import resident_frontier as RF
    from spark_fsm_tpu_torch.ops import rule_support as RS
    from spark_fsm_tpu_torch.ops.ragged_batch import next_pow2
    from spark_fsm_tpu_torch.profile_mine import predict_prefixes
    from spark_fsm_tpu_torch.service import model as SM
    from spark_fsm_tpu_torch.service.planner import choose_patterns_engine
    from spark_fsm_tpu_torch.streaming import (
        IncrementalWindowMiner, WindowMiner)
    from spark_fsm_tpu_torch.utils.canonical import (
        diff_patterns, patterns_text, rules_text)

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # 1. the card
    card = smi("name,power.limit")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f"[card] nvidia-smi: {card} | torch: {kind} x{count} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    # 2. build: one nvcc per source and the tokenizer's gcc, all started
    # together
    sources = ("pair_support", "rule_support", "extend_prune")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources) + 1) as pool:
        tok_build = pool.submit(fasttok.build)
        libs = list(pool.map(_build.build, sources))
        tok_err = tok_build.exception()
    PS._kernel()
    RS._kernel()
    EP._kernel()
    build_s = time.perf_counter() - t0
    for name, lib_path in zip(sources, libs):
        usage = ptxas_usage(_build.build_log(name))
        check(bool(usage), f"the {name} build printed no ptxas report")
        print(f"[build] {name}.cu -> {os.path.basename(lib_path)}; ptxas: "
              f"{'; '.join(usage)}", flush=True)
    print(f"[build] {len(sources)} sources and the tokenizer in "
          f"{build_s:.3f} s", flush=True)
    print(f"[tok] tokenizer: {fasttok.backend()}"
          + ("" if fasttok.backend() == "native"
             else f" (native build failed: {fasttok.reason() or tok_err})"),
          flush=True)

    # 3. kernel == plain version, exactly, on ragged shapes and at the main
    # path's launches
    rng = np.random.default_rng(0)
    worst = 0
    timed = {}
    for (P, NI, S, W) in ((130, 77, 1001, 1), (67, 129, 517, 2),
                          (3, 5, 4099, 3), LATE_WAVE, CLASSIC_LAUNCH,
                          WIDE_WAVE, HEADLINE, STREAM_SWEEP):
        pt = torch.from_numpy(rand_words(rng, P, S * W).view(np.int32)).to(dev)
        items = torch.from_numpy(
            rand_words(rng, NI + 7, S * W).view(np.int32)).to(dev)
        got = PS.pair_supports(pt, items, NI, n_words=W)
        want = PS.pair_supports_plain(pt, items, NI, n_words=W)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        check(err == 0, f"pair_supports != plain at P={P} NI={NI} S={S} "
              f"W={W} (max abs err {err})")
        pref = torch.from_numpy(rng.integers(0, P, 999)).to(dev)
        item = torch.from_numpy(rng.integers(0, NI, 999)).to(dev)
        gb = PS.batch_supports(pt, items, NI, pref, item, n_words=W)
        wb = PS.batch_supports_plain(pt, items, NI, pref, item, n_words=W)
        check(torch.equal(gb, wb), f"batch_supports != plain at W={W}")
        worst = max(worst, err)
        print(f"[check] pair_supports P={P} NI={NI} S={S} W={W}: equal to "
              f"plain (max abs err {err}); batch_supports equal", flush=True)
        if (P, NI, S, W) in (LATE_WAVE, CLASSIC_LAUNCH, WIDE_WAVE, HEADLINE,
                             STREAM_SWEEP):
            timed[(P, NI, S, W)] = (pt, items)

    # 4. timing at every launch shape above; the kernels line reports the
    # main path's wide queue wave
    pair_times = {}
    for shape in (LATE_WAVE, CLASSIC_LAUNCH, HEADLINE, STREAM_SWEEP,
                  WIDE_WAVE):
        pt, items = timed.pop(shape)
        P, NI, S, W = shape
        ms = time_ms(lambda: PS.pair_supports(pt, items, NI, n_words=W), 3, 20)
        plain_ms = time_ms(
            lambda: PS.pair_supports_plain(pt, items, NI, n_words=W), 1, 10)
        bound_ms, bound_by = pair_bound_ms(P, NI, S, W)
        pair_times[shape] = ms
        clocks = smi("clocks.sm,power.draw,temperature.gpu")
        print(f"[time] pair_supports P={P} NI={NI} S={S} W={W}: kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}, {100 * bound_ms / ms:.1f} % of it reached), "
              f"library: none (no single PyTorch call counts 'any' per "
              f"sequence); after timing nvidia-smi sm clock, power, temp: "
              f"{clocks}", flush=True)
        del pt, items
    torch.cuda.empty_cache()

    # 5. the main path at full data size: the router's choice, the queue
    # engine, with B1 launched once per wave
    t0 = time.perf_counter()
    db = bms_webview2_like()
    gen_s = time.perf_counter() - t0
    minsup = abs_minsup(0.001, len(db))
    vdb = build_vertical(db, min_item_support=minsup)
    geo = queue_geometry(vdb.n_sequences, vdb.n_items, vdb.n_words,
                         device=dev)
    store_bytes = ((geo["ni_pad"] + geo["caps"].ring + 2) * geo["n_seq"]
                   * vdb.n_words * 4)
    check(queue_eligible(vdb, dev),
          "the BMS-shaped mine is not queue-eligible")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    PS.pair_supports.launches = 0
    stats: dict = {}
    t0 = time.perf_counter()
    got = mine_spade_torch(db, minsup, stats_out=stats)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    launches = PS.pair_supports.launches
    peak = torch.cuda.max_memory_allocated()
    check(stats.get("fused") == "queue",
          f"the router sent the main path to {stats.get('fused')!r}, not the "
          f"queue engine")
    check(not stats.get("fused_overflow"), "the queue engine overflowed")
    check(launches == stats["waves"] > 0,
          f"{launches} pair-support launches for {stats['waves']} waves")
    wstats: dict = {}
    t0 = time.perf_counter()
    got_warm = mine_spade_torch(db, minsup, stats_out=wstats)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    oracle_s, text = collect_oracle(oracles["bms"], "BMS SPADE")
    check(patterns_text(got) == text, "main-path mine differs from the oracle")
    check(patterns_text(got_warm) == text, "warm mine differs from the oracle")
    wide = stats["waves"] - stats["late_waves"]
    main_bound_ms = (wide * pair_bound_ms(*WIDE_WAVE)[0]
                     + stats["late_waves"] * pair_bound_ms(*LATE_WAVE)[0])
    print(f"[mine] bms_webview2_like: {len(db)} sequences, {vdb.n_items} "
          f"frequent items, W={vdb.n_words}, minsup {minsup}: route "
          f"{stats['fused']!r}, {len(got)} patterns byte-identical to the "
          f"oracle; cold {cold_s:.3f} s, warm {warm_s:.3f} s; waves "
          f"{stats['waves']} ({wide} wide at nb {geo['caps'].nb}, "
          f"{stats['late_waves']} late at nb {geo['nb_late']}), pair-support "
          f"launches {launches} (bound summed over them {main_bound_ms:.3f} "
          f"ms), candidates {stats['candidates']}, ring {geo['caps'].ring}, "
          f"store {store_bytes} B, counter waits {stats['wait_s']:.4f} s "
          f"cold / {wstats['wait_s']:.4f} s warm, max_memory_allocated "
          f"{peak} B; host: generator {gen_s:.1f} s, oracle {oracle_s:.1f} s "
          "(child process)",
          flush=True)
    # phase 21 holds the mesh mines against this phase's text and walls
    mesh_want = {"spade auto": digest(text), "spade never": digest(text)}
    single_walls = {"spade auto": (round(cold_s, 3), round(warm_s, 3))}
    # phase 20 serves predictions from each path's output
    predict_sets = {"spade": ("bms_webview2_like SPADE minsup 0.1 %",
                              "patterns", SM.serialize_patterns(got),
                              predict_prefixes(db, 2))}
    del got, got_warm
    torch.cuda.empty_cache()

    # the same mine through the classic engine, pinned
    PS.pair_supports.launches = 0
    cstats: dict = {}
    t0 = time.perf_counter()
    got = mine_spade_torch(db, minsup, fused="never", stats_out=cstats)
    torch.cuda.synchronize()
    classic_s = time.perf_counter() - t0
    c_launches = PS.pair_supports.launches
    check(cstats["fused"] is False and c_launches > 0,
          f"the classic route: {cstats['fused']!r}, {c_launches} launches")
    check(patterns_text(got) == text, "the classic engine differs from the "
          "oracle:\n" + diff_patterns(mine_spade(db, minsup), got))
    single_walls["spade never"] = (round(classic_s, 3),)
    print(f"[mine] bms_webview2_like fused='never': {len(got)} patterns "
          f"byte-identical to the oracle; {classic_s:.3f} s, pair-support "
          f"launches {c_launches}, candidates {cstats['candidates']}",
          flush=True)

    # pinned to the dense engine: the frontier's widest level (766 nodes)
    # fits its 1,024 lanes, so it mines with one launch per level
    PS.pair_supports.launches = 0
    dstats: dict = {}
    t0 = time.perf_counter()
    got = mine_spade_torch(db, minsup, fused="dense", stats_out=dstats)
    torch.cuda.synchronize()
    dense_s = time.perf_counter() - t0
    check(dstats["fused"] is True,
          f"fused='dense' at full size did not run the dense engine: "
          f"{ {k: v for k, v in dstats.items() if k.startswith('fused')} }")
    check(PS.pair_supports.launches == dstats["levels"] > 0,
          f"{PS.pair_supports.launches} launches for {dstats['levels']} "
          f"levels")
    check(patterns_text(got) == text, "the dense engine differs from the "
          "oracle:\n" + diff_patterns(mine_spade(db, minsup), got))
    print(f"[mine] bms_webview2_like fused='dense': {len(got)} patterns "
          f"byte-identical to the oracle; {dense_s:.3f} s, levels "
          f"{dstats['levels']} = pair-support launches, candidates "
          f"{dstats['candidates']}, counter waits {dstats['wait_s']:.4f} s",
          flush=True)

    # at minsup 50 the second level (about 1,250 nodes) overflows the dense
    # frontier (and the queue engine's 1,024 children a wave): the mine
    # falls back to the classic engine, held against the SPAM engine's
    low = 50
    PS.pair_supports.launches = 0
    ostats: dict = {}
    t0 = time.perf_counter()
    got = mine_spade_torch(db, low, fused="dense", stats_out=ostats)
    torch.cuda.synchronize()
    over_s = time.perf_counter() - t0
    check(ostats.get("fused_overflow") and ostats["fused"] is False,
          f"fused='dense' at minsup {low} did not overflow and fall back: "
          f"{ {k: v for k, v in ostats.items() if k.startswith('fused')} }")
    over_launches = PS.pair_supports.launches
    astats: dict = {}
    t0 = time.perf_counter()
    got_auto = mine_spade_torch(db, low, stats_out=astats)
    torch.cuda.synchronize()
    auto_s = time.perf_counter() - t0
    want_low = mine_spam_torch(db, low)
    check(patterns_text(got) == patterns_text(want_low)
          and patterns_text(got_auto) == patterns_text(want_low),
          f"the fallbacks at minsup {low} differ from the SPAM engine's mine")
    print(f"[mine] bms_webview2_like minsup {low}: fused='dense' overflowed "
          f"after {ostats['fused_levels']} levels and fell back to the classic "
          f"engine ({over_s:.3f} s, pair-support launches {over_launches}); "
          f"fused='auto' routed "
          f"{ {k: v for k, v in astats.items() if k.startswith('fused')} } "
          f"({auto_s:.3f} s); both {len(got)} patterns byte-identical to the "
          f"SPAM engine's", flush=True)
    del got_auto

    # checkpointed: the queue engine in segments; a mid-mine snapshot
    # resumes in the classic engine
    ckpt = SnapshotStore()
    PS.pair_supports.launches = 0
    kstats: dict = {}
    t0 = time.perf_counter()
    got = mine_spade_torch(db, minsup, checkpoint=ckpt, stats_out=kstats)
    torch.cuda.synchronize()
    ckpt_s = time.perf_counter() - t0
    check(kstats["fused"] == "queue" and kstats.get("checkpoints", 0) > 0,
          f"the checkpointed mine: route {kstats['fused']!r}, "
          f"{kstats.get('checkpoints', 0)} snapshots")
    check(PS.pair_supports.launches == kstats["waves"],
          f"{PS.pair_supports.launches} launches for {kstats['waves']} waves")
    check(patterns_text(got) == text, "the checkpointed mine differs")
    k = len(ckpt.saved) // 2
    snap = ckpt.merged(k)
    check(bool(snap["stack"]), "the mid-mine snapshot holds no frontier")
    t0 = time.perf_counter()
    resumed = SpadeTorch(vdb, minsup).mine(resume=snap)
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t0
    check(patterns_text(resumed) == text,
          "the classic engine's resume of a queue snapshot differs")
    print(f"[mine] bms_webview2_like checkpointed: {kstats['checkpoints']} "
          f"snapshots over {kstats['waves']} waves, byte-identical; "
          f"{ckpt_s:.3f} s; snapshot {k} ({len(snap['stack'])} live nodes, "
          f"{len(snap['results'])} results) resumed in the classic engine, "
          f"byte-identical, {resume_s:.3f} s", flush=True)
    del got, resumed, snap, ckpt
    torch.cuda.empty_cache()

    tokenizer_times("bms_webview2_like", db, minsup)
    bms_db, bms_minsup, bms_text = db, minsup, text
    del want_low, vdb
    torch.cuda.empty_cache()

    # 6. multiword mine
    db = synthetic_db(seed=8, n_sequences=120, n_items=12, mean_itemsets=40.0,
                      max_itemsets=80)
    minsup_w = abs_minsup(0.5, len(db))
    vdb = build_vertical(db, min_item_support=minsup_w)
    check(vdb.n_words >= 2, f"multiword fixture has W={vdb.n_words}")
    PS.pair_supports.launches = 0
    got = mine_spade_torch(db, minsup_w, max_pattern_itemsets=3)
    torch.cuda.synchronize()
    mw_launches = PS.pair_supports.launches
    want = mine_spade(db, minsup_w, max_pattern_itemsets=3)
    check(patterns_text(got) == patterns_text(want),
          "multiword mine differs from the oracle:\n" + diff_patterns(want, got))
    check(mw_launches > 0, "the multiword mine launched the kernel 0 times")
    print(f"[mine] multiword W={vdb.n_words}: {len(got)} patterns "
          f"byte-identical to the oracle, pair-support launches {mw_launches}",
          flush=True)

    pair_record = {
        "name": "pair_support", "route": "cuda",
        "source": "spark_fsm_tpu_torch/csrc/pair_support.cu",
        "replaces": "spark_fsm_tpu/ops/pallas_support.py:202",
        "launches": launches, "max_abs_err": worst,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None,
    }
    del db, got, want, vdb
    torch.cuda.empty_cache()

    # 7. rule-support kernel == plain version, exactly
    rworst = 0
    shapes = [(C, km, 24, S, W) for (C, S, W) in ((77, 1001, 1), (130, 517, 2),
                                                   (257, 4099, 3))
              for km in RB.KM_LADDER] + [
        (200, 3, 24, 2500, 1),
        # the staged path at its largest store, and the walk path past it
        (300, 2, RS.staged_max_rows(2), 2500, 1),
        (300, 2, RS.staged_max_rows(2) + 1, 2500, 1),
        RULE_RESIDENT_LATE, RULE_RESIDENT_WIDE, RULE_KM1, RULE_HEADLINE]
    for i, (C, km, M, S, W) in enumerate(shapes):
        p1, s1, xy = rule_operands(dev, 100 + i, C, km, M, S, W)
        if i == 0:
            xy[: C // 2, 0] = -1        # all of one side unused: the pad row
        elif i == 1:
            xy[: C // 2, 1] = -1
        got_r = RS.rule_supports(p1, s1, xy, n_words=W)
        want_r = RS.rule_supports_plain(p1, s1, xy, n_words=W)
        torch.cuda.synchronize()
        err = int((got_r.long() - want_r.long()).abs().max())
        check(err == 0, f"rule_supports != plain at C={C} km={km} M={M} "
              f"S={S} W={W} (max abs err {err})")
        rworst = max(rworst, err)
        print(f"[check] rule_supports C={C} km={km} M={M} S={S} W={W}: "
              f"equal to plain (max abs err {err})", flush=True)
        del p1, s1, xy, got_r, want_r
    torch.cuda.empty_cache()

    # 8. timing at the resident waves, at km = 1 and at the headline launch;
    # the kernels line reports the headline launch, timed last
    for i, shape in enumerate((RULE_RESIDENT_LATE, RULE_RESIDENT_WIDE,
                               RULE_KM1, RULE_HEADLINE)):
        C, km, M, S, W = shape
        p1, s1, xy = rule_operands(dev, 200 + i, C, km, M, S, W)
        rms = time_ms(lambda: RS.rule_supports(p1, s1, xy, n_words=W), 2, 10)
        rplain_ms = time_ms(
            lambda: RS.rule_supports_plain(p1, s1, xy, n_words=W), 1, 3)
        rbound_ms, rbound_by = rule_bound_ms(xy, S, W)
        clocks = smi("clocks.sm,power.draw,temperature.gpu")
        print(f"[time] rule_supports C={C} km={km} M={M} S={S} W={W}: kernel "
              f"{rms:.4f} ms, plain {rplain_ms:.4f} ms, bound {rbound_ms:.4f} "
              f"ms ({rbound_by}, {rule_rows(xy)} of {2 * M} store rows "
              f"named, {100 * rbound_ms / rms:.1f} % of it "
              f"reached), library: none (no single PyTorch call folds row "
              f"ANDs, shifts with a carry and counts 'any' per sequence); "
              f"after timing nvidia-smi sm clock, power, temp: {clocks}",
              flush=True)
        del p1, s1, xy
    torch.cuda.empty_cache()

    # 9. the TSR path at full data size
    t0 = time.perf_counter()
    db = kosarak_like(scale=1.0, fast=True)
    gen_s = time.perf_counter() - t0
    vdb = tokenizer_times("kosarak_like", db, 1, sample=10)   # the recount's
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    RS.rule_supports.launches = 0
    tstats: dict = {}
    t0 = time.perf_counter()
    rules = mine_tsr_torch(db, 100, 0.5, max_side=2, stats_out=tstats)
    torch.cuda.synchronize()
    tcold_s = time.perf_counter() - t0
    rlaunches = RS.rule_supports.launches
    tpeak = torch.cuda.max_memory_allocated()
    check(rlaunches > 0, "the TSR path launched the rule-support kernel 0 times")
    check(len(rules) >= 100, f"the TSR mine returned {len(rules)} < k rules")
    t0 = time.perf_counter()
    rules_warm = mine_tsr_torch(db, 100, 0.5, max_side=2)
    torch.cuda.synchronize()
    twarm_s = time.perf_counter() - t0
    text = rules_text(rules)
    check(rules_text(rules_warm) == text, "warm TSR mine differs from cold")
    t0 = time.perf_counter()
    recount = recount_rules(vdb, rules)
    recount_s = time.perf_counter() - t0
    bad = [(r, c) for r, c in zip(rules, recount) if r != c]
    check(not bad, f"host recount disagrees on {len(bad)} rules, e.g. {bad[:3]}")
    km_stats = {k: v for k, v in tstats.items()
                if k.startswith(("launches_km", "evaluated_km", "width_km"))}
    print(f"[mine] kosarak_like: {len(db)} sequences, {vdb.n_items} items, "
          f"W={vdb.n_words}, k=100 minconf=0.5 max_side=2: {len(rules)} rules "
          f"byte-identical to the host recount (the plain route is held on "
          f"phase 21's tenth); cold {tcold_s:.3f} s, warm {twarm_s:.3f} s; "
          f"rule-support launches {rlaunches}, "
          f"evaluated {tstats['evaluated']}, pruned_conf "
          f"{tstats['pruned_conf']}, deepening_rounds "
          f"{tstats['deepening_rounds']}, {km_stats}; "
          f"max_memory_allocated {tpeak} B; host: generator {gen_s:.1f} s, "
          f"recount {recount_s:.1f} s", flush=True)
    kos_vdb = vdb   # phase 15 mines it again
    service_dbs = {"kosarak": db}   # phase 23 serves it
    mesh_want["tsr"] = digest(text)
    single_walls["tsr"] = (round(tcold_s, 3), round(twarm_s, 3))
    predict_sets["tsr"] = ("kosarak_like TSR k=100", "rules",
                           SM.serialize_rules(rules), predict_prefixes(db, 1))
    del db, rules, rules_warm, vdb
    torch.cuda.empty_cache()

    # 10. the TSR path against the copied CPU oracle
    for name, db, k, minconf, side in (
            ("kosarak_like(scale=0.01)", kosarak_like(scale=0.01, fast=True),
             100, 0.5, 2),
            ("multiword synthetic_db(seed=8)",
             synthetic_db(seed=8, n_sequences=120, n_items=12,
                          mean_itemsets=40.0, max_itemsets=80), 10, 0.3, 3)):
        n_words = build_vertical(db, min_item_support=1).n_words
        before = RS.rule_supports.launches
        got_t = mine_tsr_torch(db, k, minconf, max_side=side)
        torch.cuda.synchronize()
        n_l = RS.rule_supports.launches - before
        want_t = mine_tsr_cpu(db, k, minconf, max_side=side)
        check(rules_text(got_t) == rules_text(want_t),
              f"TSR mine of {name} differs from mine_tsr_cpu")
        check(n_l > 0, f"the TSR mine of {name} launched the kernel 0 times")
        print(f"[mine] {name}: W={n_words}, {len(got_t)} rules byte-identical "
              f"to mine_tsr_cpu, rule-support launches {n_l}", flush=True)
    check(n_words >= 2, f"the multiword TSR fixture has W={n_words}")

    rule_record = {
        "name": "rule_support", "route": "cuda",
        "source": "spark_fsm_tpu_torch/csrc/rule_support.cu",
        "replaces": "spark_fsm_tpu/ops/pallas_tsr.py:145",
        "launches": rlaunches, "max_abs_err": rworst,
        "ms": rms, "plain_ms": rplain_ms, "bound_ms": rbound_ms,
        "bound_by": rbound_by, "library_ms": None,
    }
    del db, got_t, want_t
    torch.cuda.empty_cache()

    # 11. extension-count-prune kernel == plain version, exactly
    nb = spam_geometry(990000, 17, 1, device=dev)["node_batch"]
    msnbc_wave = (2 * nb, 64, 990016, 1)
    eworst = 0
    ewaves = {}
    for (P, NI, n_items, S, W) in ((12, 64, 17, 1001, 1), (37, 128, 100, 4099, 2),
                                   (128, 64, 26, 517, 3), (14, 128, 90, 77503, 1),
                                   msnbc_wave[:2] + (17,) + msnbc_wave[2:],
                                   BMS_WAVE[:2] + (26,) + BMS_WAVE[2:]):
        pt = torch.from_numpy(rand_words(rng, P, S * W).view(np.int32)).to(dev)
        items = torch.from_numpy(
            rand_words(rng, NI + 3, S * W).view(np.int32)).to(dev)
        items[n_items:NI] = 0                   # all-zero pad item rows
        counts = PS.pair_supports(pt, items, NI, n_words=W)
        # the median over the live item lanes: pad lanes count 0
        median = max(1, int(counts[:, :n_items].float().median()))
        for thr in (1, median, int(counts.max()) + 1):
            want_s, want_m = EP.extend_count_prune_plain(
                pt.view(P, S, W), items[:NI].view(NI, S, W), thr,
                torch.zeros(P, dtype=torch.bool))
            for hint in (n_items, None):
                sup, mask = EP.extend_count_prune(pt, items, thr, NI,
                                                  n_words=W, n_live=hint)
                torch.cuda.synchronize()
                err = int((sup.long() - want_s.long()).abs().max())
                check(err == 0 and torch.equal(mask, want_m),
                      f"extend_count_prune != plain at P={P} NI={NI} S={S} "
                      f"W={W} thr={thr} n_live={hint} (max abs err {err})")
                if thr == 1:
                    check(torch.equal(sup, counts), f"extend_count_prune at "
                          f"thr=1 != pair_supports at P={P} NI={NI} S={S} "
                          f"W={W} n_live={hint}")
                eworst = max(eworst, err)
        print(f"[check] extend_count_prune P={P} NI={NI} ({n_items} items, "
              f"pad rows zero) S={S} W={W}: sup and mask equal to plain at "
              f"thr 1, median, max+1, with n_live={n_items} and without; "
              f"equal to pair_supports at thr 1", flush=True)
        if (P, NI, S, W) in (msnbc_wave, BMS_WAVE):
            ewaves[(P, NI, S, W)] = (pt, items, median, n_items)
        del pt, items, counts, sup, mask, want_s, want_m

    # 12. timing at the BMS dense wave and at the MSNBC wave: without the
    # live-row hint at the median count (against the bound over all NI
    # lanes), then with it at threshold 1 and at the median (against the
    # bound over the live lanes); the kernels line reports the MSNBC wave
    # (the main path's) with the hint at the median, timed last
    for shape in (BMS_WAVE, msnbc_wave):
        pt, items, median, n_live = ewaves.pop(shape)
        P, NI, S, W = shape
        for hint, thr in ((None, median), (n_live, 1), (n_live, median)):
            ebound_ms, ebound_by = extend_bound_ms(P, NI, S, W, hint)
            ems = launch_ms(
                lambda: EP.extend_count_prune(pt, items, thr, NI, n_words=W,
                                              n_live=hint), 3, 50)
            print(f"[time] extend_count_prune P={P} NI={NI} S={S} W={W} "
                  f"n_live={hint or NI} thr={thr}: kernel {ems:.4f} ms, "
                  f"bound {ebound_ms:.4f} ms ({ebound_by}, "
                  f"{100 * ebound_ms / ems:.1f} % of it reached)", flush=True)
        eplain_ms = time_ms(lambda: EP.extend_count_prune_plain(
            pt.view(P, S, W), items[:NI].view(NI, S, W), thr,
            torch.zeros(P, dtype=torch.bool, device=dev)), 1, 5)
        clocks = smi("clocks.sm,power.draw,temperature.gpu")
        print(f"[time] extend_count_prune P={P} NI={NI} S={S} W={W} thr={thr}: "
              f"plain {eplain_ms:.4f} ms, library: none (no single PyTorch "
              f"call counts 'any' per sequence, thresholds and packs a mask); "
              f"after timing nvidia-smi sm clock, power, temp: {clocks}",
              flush=True)
        del pt, items
    torch.cuda.empty_cache()

    # 13. the SPAM path at full data size
    t0 = time.perf_counter()
    db = msnbc_like(scale=1.0, fast=True)
    gen_s = time.perf_counter() - t0
    minsup = abs_minsup(0.005, len(db))
    tokenizer_times("msnbc_like", db, minsup, sample=10)
    decision = choose_patterns_engine(dataset_stats(db, min_item_support=minsup))
    check(decision.engine == "SPAM_TPU",
          f"the planner routes the MSNBC-shaped mine to {decision.engine}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    EP.extend_count_prune.launches = 0
    PS.pair_supports.launches = 0
    RS.rule_supports.launches = 0
    sstats: dict = {}
    t0 = time.perf_counter()
    got = mine_spam_torch(db, minsup, stats_out=sstats)
    torch.cuda.synchronize()
    scold_s = time.perf_counter() - t0
    elaunches = EP.extend_count_prune.launches
    speak = torch.cuda.max_memory_allocated()
    check(elaunches > 0, "the SPAM path launched the extend-prune kernel 0 times")
    check(elaunches == sstats["waves"],
          f"{elaunches} extend-prune launches for {sstats['waves']} waves")
    check(PS.pair_supports.launches == 0 and RS.rule_supports.launches == 0,
          "the pure-bitmap SPAM path launched another kernel")
    t0 = time.perf_counter()
    got_warm = mine_spam_torch(db, minsup)
    torch.cuda.synchronize()
    swarm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got_spade = mine_spade_torch(db, minsup)
    torch.cuda.synchronize()
    spade_s = time.perf_counter() - t0
    oracle_s, text = collect_oracle(oracles["msnbc"], "MSNBC SPADE")
    check(patterns_text(got) == text, "SPAM mine differs from the oracle")
    check(patterns_text(got_warm) == text, "warm SPAM mine differs from the oracle")
    check(patterns_text(got_spade) == text,
          "SPAM and the SPADE route differ on the MSNBC-shaped mine")
    print(f"[mine] msnbc_like: {len(db)} sequences, {sstats['rep_dense']} "
          f"frequent items, minsup {minsup}, planner: {decision.engine} "
          f"({decision.reason}): {len(got)} patterns byte-identical to the "
          f"oracle and to the SPADE route's; cold {scold_s:.3f} s, warm "
          f"{swarm_s:.3f} s, SPADE route {spade_s:.3f} s; node_batch {nb}, "
          f"waves {sstats['waves']}, extend-prune launches {elaunches}, "
          f"candidates {sstats['candidates']}, evaluated_lanes "
          f"{sstats['evaluated_lanes']}, wave_survivors "
          f"{sstats['wave_survivors']}, diffset_nodes {sstats['diffset_nodes']}, "
          f"engine launches {sstats['kernel_launches']}, recomputed_nodes "
          f"{sstats['recomputed_nodes']}; max_memory_allocated {speak} B; host: "
          f"generator {gen_s:.1f} s, oracle {oracle_s:.1f} s (child process)",
          flush=True)
    mesh_want["spam"] = digest(text)
    single_walls["spam"] = (round(scold_s, 3), round(swarm_s, 3))
    part_inputs = {"msnbc": (db, minsup)}   # phase 22 mines them again
    predict_sets["spam"] = ("msnbc_like SPAM minsup 0.5 %", "patterns",
                            SM.serialize_patterns(got),
                            predict_prefixes(db, 3))
    del db, got, got_warm, got_spade
    torch.cuda.empty_cache()

    # 14. the SPAM path on the hybrid plan, and a multiword SPAM mine
    EP.extend_count_prune.launches = 0
    hstats: dict = {}
    t0 = time.perf_counter()
    got = mine_spam_torch(bms_db, bms_minsup, stats_out=hstats)
    torch.cuda.synchronize()
    hybrid_s = time.perf_counter() - t0
    hlaunches = EP.extend_count_prune.launches
    check(patterns_text(got) == bms_text,
          "hybrid SPAM mine differs from phase 5's oracle result")
    check(hstats["rep_dense"] > 0 and hstats["rep_idlist"] > 0,
          f"the BMS-shaped plan is not hybrid: {hstats['rep_dense']} dense, "
          f"{hstats['rep_idlist']} id-list items")
    check(hstats["pair_launches"] > 0, "the hybrid mine made no pair launches")
    check(hlaunches == hstats["waves"] > 0,
          f"{hlaunches} extend-prune launches for {hstats['waves']} waves")
    print(f"[mine] bms_webview2_like hybrid SPAM: rep_dense "
          f"{hstats['rep_dense']}, rep_idlist {hstats['rep_idlist']}, "
          f"{len(got)} patterns byte-identical to phase 5's oracle result; "
          f"{hybrid_s:.3f} s; waves {hstats['waves']}, extend-prune launches "
          f"{hlaunches}, pair_launches {hstats['pair_launches']}, candidates "
          f"{hstats['candidates']}, diffset_nodes {hstats['diffset_nodes']}",
          flush=True)
    del got
    db = synthetic_db(seed=8, n_sequences=120, n_items=12, mean_itemsets=40.0,
                      max_itemsets=80)
    minsup_w = abs_minsup(0.5, len(db))
    before = EP.extend_count_prune.launches
    got = mine_spam_torch(db, minsup_w, max_pattern_itemsets=3)
    torch.cuda.synchronize()
    n_l = EP.extend_count_prune.launches - before
    want = mine_spade(db, minsup_w, max_pattern_itemsets=3)
    check(patterns_text(got) == patterns_text(want),
          "multiword SPAM mine differs from the oracle:\n" + diff_patterns(want, got))
    check(n_l > 0, "the multiword SPAM mine launched the kernel 0 times")
    print(f"[mine] multiword SPAM W={build_vertical(db).n_words}: {len(got)} "
          f"patterns byte-identical to the oracle, extend-prune launches {n_l}",
          flush=True)

    del db, got, want
    torch.cuda.empty_cache()

    # 15. TSR's resident-frontier route at full data size
    m0 = min(256, kos_vdb.n_items)   # the first deepening round's top-m
    probe = TsrTorch(kos_vdb, 100, 0.5, max_side=None)
    auto_resident = probe._resident_route(m0)
    caps = RF.caps_for(kos_vdb.n_sequences, kos_vdb.n_words, m0,
                       probe._ensure_budget())
    units = RB.overhead_units(kos_vdb.n_sequences, kos_vdb.n_words)
    check(auto_resident == (units >= caps.nb),
          f"auto's route {auto_resident} at overhead_units {units}, nb "
          f"{caps.nb}")
    del probe
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    RS.rule_supports.launches = 0
    # each wave's candidates kept on the card (a copy, no host sync), so
    # the bound can be summed over this run's wave launches afterwards
    plain_wave, launched = RF.wave, []

    def wave_keeping_candidates(*args):
        *head, evaluate = args

        def keep(p1, s1, xy, n_words):
            launched.append(xy.clone())
            return evaluate(p1, s1, xy, n_words)

        return plain_wave(*head, keep)

    RF.wave = wave_keeping_candidates
    try:
        eng = TsrTorch(kos_vdb, 100, 0.5, max_side=None, resident="always")
        t0 = time.perf_counter()
        res_rules = eng.mine()
        torch.cuda.synchronize()
        rcold_s = time.perf_counter() - t0
    finally:
        RF.wave = plain_wave
    res_launches = RS.rule_supports.launches
    rpeak = torch.cuda.max_memory_allocated()
    rstats = eng.stats
    host_launches = sum(v for key, v in rstats.items()
                        if key.startswith("launches_km"))
    check(rstats.get("resident") is True and rstats["resident_waves"] > 0,
          f"resident='always' did not run the resident route: {rstats}")
    check(res_launches == rstats["resident_waves"] + host_launches,
          f"{res_launches} rule-support launches for "
          f"{rstats['resident_waves']} waves and {host_launches} host-loop "
          f"launches")
    n_waves = rstats["resident_waves"]
    check(len(launched) == n_waves,
          f"{len(launched)} wave evaluations seen for {n_waves} waves")
    S_k, W_k = kos_vdb.n_sequences, kos_vdb.n_words
    wave_rows = [rule_rows(xy) for xy in launched]
    wave_bound_ms = sum(rule_bound_ms(xy, S_k, W_k)[0] for xy in launched)
    del launched
    eng = TsrTorch(kos_vdb, 100, 0.5, max_side=None, resident="always")
    t0 = time.perf_counter()
    res_warm = eng.mine()
    torch.cuda.synchronize()
    rwarm_s = time.perf_counter() - t0
    rwstats = eng.stats
    before = RS.rule_supports.launches
    eng = TsrTorch(kos_vdb, 100, 0.5, max_side=None, resident="never")
    t0 = time.perf_counter()
    host_rules = eng.mine()
    torch.cuda.synchronize()
    rhost_s = time.perf_counter() - t0
    hstats = eng.stats
    hl = RS.rule_supports.launches - before
    del eng
    text = rules_text(res_rules)
    check(rules_text(res_warm) == text, "warm resident mine differs")
    check(rules_text(host_rules) == text,
          "the resident route's rules differ from the host loop's")
    t0 = time.perf_counter()
    recount = recount_rules(kos_vdb, res_rules)
    recount_s = time.perf_counter() - t0
    bad = [(r, c) for r, c in zip(res_rules, recount) if r != c]
    check(not bad, f"host recount disagrees on {len(bad)} rules, e.g. {bad[:3]}")
    route_keys = ("resident_rounds", "resident_segments", "resident_waves",
                  "resident_deferred", "resident_spills", "resident_handoffs",
                  "resident_readback_bytes", "evaluated", "pruned_conf",
                  "kernel_launches", "deepening_rounds")
    print(f"[mine] kosarak_like max_side=None: {kos_vdb.n_sequences} "
          f"sequences, k=100 minconf=0.5: auto picks "
          f"{'the resident route' if auto_resident else 'the host loop'} "
          f"(overhead_units {units} vs caps.nb {caps.nb}; caps ring "
          f"{caps.ring}, nb_late {caps.nb_late}); resident='always': "
          f"{len(res_rules)} rules byte-identical to resident='never' and to "
          f"the host recount; cold {rcold_s:.3f} s, warm {rwarm_s:.3f} s, "
          f"host loop {rhost_s:.3f} s; "
          f"{ {k: rstats.get(k, 0) for k in route_keys} }, rule-support "
          f"launches {res_launches} ({host_launches} of them host-loop), "
          f"counter waits {rstats.get('wait_s', 0.0):.4f} s cold / "
          f"{rwstats.get('wait_s', 0.0):.4f} s warm; host loop: evaluated "
          f"{hstats['evaluated']}, rule-support launches {hl}; "
          f"max_memory_allocated {rpeak} B; recount {recount_s:.1f} s",
          flush=True)
    print(f"[bound] rule_supports on the resident route: {n_waves} wave "
          f"launches name {statistics.mean(wave_rows):.1f} store rows each "
          f"(min {min(wave_rows)}, max {max(wave_rows)}), bound summed over "
          f"them {wave_bound_ms:.3f} ms", flush=True)
    del res_rules, res_warm, host_rules   # phase 22 mines kos_vdb again
    torch.cuda.empty_cache()

    db = kosarak_like(scale=0.01, fast=True)
    s1: dict = {}
    before = RS.rule_supports.launches
    t0 = time.perf_counter()
    got_t = mine_tsr_torch(db, 100, 0.5, max_side=None, stats_out=s1)
    torch.cuda.synchronize()
    small_s = time.perf_counter() - t0
    n_l = RS.rule_supports.launches - before
    check(s1.get("resident") is True,
          f"auto at 1 % size did not take the resident route: {s1}")
    t0 = time.perf_counter()
    want_t = mine_tsr_cpu(db, 100, 0.5, max_side=None)
    cpu_s = time.perf_counter() - t0
    text = rules_text(want_t)
    check(rules_text(got_t) == text,
          "the 1 % resident mine differs from mine_tsr_cpu")
    # the user's default request at this size on both routes, warm, in
    # turns on one vertical DB: auto (the resident route) and the host loop
    small_vdb = build_vertical(db, min_item_support=1)
    small_walls = {"auto": [], "never": []}
    for _ in range(3):
        for resident, walls in small_walls.items():
            eng = TsrTorch(small_vdb, 100, 0.5, max_side=None,
                           resident=resident)
            t0 = time.perf_counter()
            got_r = eng.mine()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            check(rules_text(got_r) == text,
                  f"the 1 % mine with resident={resident!r} differs")
            check((eng.stats.get("resident") is True) == (resident == "auto"),
                  f"resident={resident!r} took the wrong route at 1 %")
    del eng, got_r, small_vdb
    print(f"[mine] kosarak_like(scale=0.01) max_side=None: auto took the "
          f"resident route; {len(got_t)} rules byte-identical to "
          f"mine_tsr_cpu; {small_s:.3f} s (mine_tsr_cpu {cpu_s:.1f} s); "
          f"{ {k: s1.get(k, 0) for k in route_keys} }, rule-support "
          f"launches {n_l}; warm mines in turns (vertical DB built), auto "
          f"{[round(w, 4) for w in small_walls['auto']]} s, host loop "
          f"(resident='never') {[round(w, 4) for w in small_walls['never']]} "
          f"s, medians {statistics.median(small_walls['auto']):.4f} / "
          f"{statistics.median(small_walls['never']):.4f} s", flush=True)
    tsr_small_db, tsr_small_text = db, text   # phases 19 and 22 mine it
    tsr_small_payload = SM.serialize_rules(got_t)   # phase 24 serves it
    mesh_want["tsr 1%"] = digest(text)
    del db, got_t, want_t

    # 16. constrained SPADE against the copied oracle, full size and 10 %
    for scale in GAZELLE_SCALES:
        db = gazelle_like(scale=scale, fast=True)
        minsup = abs_minsup(0.005, len(db))
        vdb = build_vertical(db, min_item_support=minsup)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cs: dict = {}
        t0 = time.perf_counter()
        got = mine_cspade_torch(db, minsup, maxgap=2, maxwindow=5,
                                stats_out=cs)
        torch.cuda.synchronize()
        ccold_s = time.perf_counter() - t0
        cpeak = torch.cuda.max_memory_allocated()
        geo = cs["geometry"]
        t0 = time.perf_counter()
        got_warm = mine_cspade_torch(db, minsup, maxgap=2, maxwindow=5)
        torch.cuda.synchronize()
        cwarm_s = time.perf_counter() - t0
        oracle_s, want_text = collect_oracle(oracles[scale], "cSPADE")
        check(patterns_text(got) == want_text,
              f"the cSPADE mine at scale {scale} differs from the oracle")
        check(patterns_text(got_warm) == want_text,
              f"the warm cSPADE mine at scale {scale} differs")
        check(len(got) > 0, f"the cSPADE mine at scale {scale} is empty")
        cspade_small = (db, minsup, want_text)   # phase 19: the last scale
        if scale == 1.0:
            part_inputs["gazelle"] = (db, minsup)
            gazelle_payload = SM.serialize_patterns(got)   # phase 23
            mesh_want["cspade"] = digest(want_text)
            single_walls["cspade"] = (round(ccold_s, 3), round(cwarm_s, 3))
        print(f"[mine] gazelle_like(scale={scale}) maxgap=2 maxwindow=5: "
              f"{len(db)} sequences, {vdb.n_items} frequent items, "
              f"W={vdb.n_words}, minsup {minsup}: {len(got)} patterns "
              f"byte-identical to the oracle; cold {ccold_s:.3f} s, warm "
              f"{cwarm_s:.3f} s, oracle {oracle_s:.1f} s (child process); "
              f"geometry dtype {geo['dtype']}, chunk {geo['chunk']}, "
              f"node_batch {geo['node_batch']}, pool_slots "
              f"{geo['pool_slots']}; candidates {cs['candidates']} "
              f"({cs['s_candidates']} s, {cs['i_candidates']} i), engine "
              f"launches {cs['kernel_launches']}, recomputed_nodes "
              f"{cs['recomputed_nodes']}; max_memory_allocated {cpeak} B",
              flush=True)
        del db, got, got_warm, vdb
        torch.cuda.empty_cache()

    # 17. streaming windows at full size: the incremental miner (B1 once
    # a swept level) and the re-mine miner, byte-identical after every push
    t0 = time.perf_counter()
    db = msnbc_like(scale=1.0, fast=True)
    per = len(db) // STREAM_PUSHES
    batches = [db[i * per:(i + 1) * per if i < STREAM_PUSHES - 1 else len(db)]
               for i in range(STREAM_PUSHES)]
    del db
    gen_s = time.perf_counter() - t0
    inc = IncrementalWindowMiner(STREAM_MINSUP, max_batches=STREAM_KEEP)
    check(inc.use_kernel, "the incremental miner on the card does not use B1")
    remine_routes = []

    def remine(seqs, minsup):
        # WindowMiner's own default mine, with the route recorded
        st: dict = {}
        res = mine_spade_torch(seqs, minsup, shape_buckets=True, stats_out=st)
        remine_routes.append(st.get("fused"))
        return res

    rem = WindowMiner(STREAM_MINSUP, max_batches=STREAM_KEEP, mine=remine)
    stream_texts, widest, swept_levels, stream_b1 = {}, 0, 0, 0
    # phase 25 serves the stream again: each push's serialization digest
    # and the library's push wall
    stream_served = {}
    stream_bound_ms = 0.0
    counters = ("repaired_nodes", "sweep_candidates", "kernel_launches")
    for push, batch in enumerate(batches, 1):
        # the levels this push's sweep walks: tracked nodes with children
        widths, lv = [], [n for n in inc._root.values() if n.children]
        while lv:
            widths.append(len(lv))
            lv = [c for n in lv for c in n.children.values() if c.children]
        widest = max([widest] + widths)
        before = {k: inc.stats[k] for k in counters}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        PS.pair_supports.launches = 0
        t0 = time.perf_counter()
        got = inc.push(batch)
        torch.cuda.synchronize()
        inc_s = time.perf_counter() - t0
        b1 = PS.pair_supports.launches
        ipeak = torch.cuda.max_memory_allocated()
        check(b1 >= 1 or not widths,
              f"push {push}: the sweep walked {len(widths)} levels but B1 "
              f"launched {b1} times")
        swept_levels += len(widths)
        stream_b1 += b1
        # B1's bound over this push's launches: a level's parents, plain
        # and transformed, against the new batch store's item rows
        st = list(inc._states.values())[-1]
        push_bound_ms = sum(pair_bound_ms(2 * w, st.ni_rows, st.n_seq,
                                          st.n_words)[0] for w in widths)
        stream_bound_ms += push_bound_ms
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        PS.pair_supports.launches = 0
        t0 = time.perf_counter()
        want = rem.push(batch)
        torch.cuda.synchronize()
        rem_s = time.perf_counter() - t0
        rb1 = PS.pair_supports.launches
        rpeak = torch.cuda.max_memory_allocated()
        text = patterns_text(got)
        check(text == patterns_text(want),
              f"push {push}: the incremental and re-mine routes differ:\n"
              + diff_patterns(want, got))
        if push in STREAM_ORACLE_PUSHES:
            stream_texts[push] = text
        stream_served[push] = (digest(SM.serialize_patterns(got)), inc_s)
        if push <= MESH_STREAM_PUSHES:
            mesh_want[f"stream push {push}"] = digest(text)
            single_walls[f"stream push {push}"] = (round(inc_s, 3),)
        delta = {k: inc.stats[k] - before[k] for k in counters}
        print(f"[stream] push {push}: window {inc.stats['window_sequences']} "
              f"sequences, minsup {inc.minsup_abs()}, {len(got)} patterns "
              f"byte-identical across the routes; incremental "
              f"{inc_s:.3f} s (phase_s {inc.stats['phase_s']}), swept level "
              f"widths {widths}, B1 launches {b1} (bound summed over them "
              f"{push_bound_ms:.3f} ms), {delta}, tracked_nodes "
              f"{inc.stats['tracked_nodes']}, store_cache_bytes "
              f"{inc.stats['store_cache_bytes']}, max_memory_allocated "
              f"{ipeak} B; re-mine {rem_s:.3f} s (route "
              f"{remine_routes[-1]!r}), B1 launches {rb1}, "
              f"max_memory_allocated {rpeak} B", flush=True)
    for push in STREAM_ORACLE_PUSHES:
        oracle_s, want_text = collect_oracle(oracles[("stream", push)],
                                             f"stream push {push}")
        check(stream_texts[push] == want_text,
              f"push {push}: the stream differs from the oracle's mine of "
              "the window")
        print(f"[stream] push {push}: byte-identical to the oracle's mine of "
              f"the window (oracle {oracle_s:.1f} s, child process)",
              flush=True)
    kept = sum(st.store is not None for st in inc._states.values())
    budget = 0.2 * device_hbm_budget(dev)
    sweep_p = 2 * next_pow2(widest)
    check(sweep_p == STREAM_SWEEP[0],
          f"the widest sweep level ({widest} parents) makes P={sweep_p}, not "
          f"phase 4's {STREAM_SWEEP[0]}")
    print(f"[stream] msnbc_like: {STREAM_PUSHES} pushes of {per} sequences, "
          f"window {STREAM_KEEP}, generator {gen_s:.1f} s; B1 launched "
          f"{stream_b1} times over {swept_levels} swept levels (bound summed "
          f"over them {stream_bound_ms:.3f} ms); widest level "
          f"{widest} parents (P = {sweep_p} at the reference's pow2 width); "
          f"warm batch stores kept {kept} of {len(inc._states)} "
          f"({inc.stats['store_cache_bytes']} B against the 0.2 x budget "
          f"{budget:.0f} B); re-mine routes {remine_routes}", flush=True)
    stream_first = batches[0]   # phase 19 mines it again
    stream_spmf = [format_spmf(b) for b in batches]   # phase 25 posts them
    stream_shape = (len(batches[0]), len({i for seq in batches[0]
                                          for its in seq for i in its}))
    del batches, inc, rem, got, want
    torch.cuda.empty_cache()

    # 18. the repair fold and multiword batches on the card
    rng = np.random.default_rng(MW_STREAM["seed"])
    mw_batches = [synthetic_db(seed=int(rng.integers(1 << 30)),
                               n_sequences=MW_STREAM["per_batch"], n_items=6,
                               mean_itemsets=40.0, mean_itemset_size=1.1)
                  for _ in range(MW_STREAM["batches"])]
    n_words = build_vertical(mw_batches[0]).n_words
    check(n_words >= 2, f"the multiword stream has W={n_words}")
    kern = IncrementalWindowMiner(MW_STREAM["minsup"], max_batches=2)
    gath = IncrementalWindowMiner(MW_STREAM["minsup"], max_batches=2,
                                  use_kernel=False)
    prev, entered, left, repaired_after_first = None, 0, 0, 0
    for push, batch in enumerate(mw_batches, 1):
        r0 = kern.stats["repaired_nodes"]
        PS.pair_supports.launches = 0
        got = kern.push(batch)
        torch.cuda.synchronize()
        b1 = PS.pair_supports.launches
        g_got = gath.push(batch)
        torch.cuda.synchronize()
        check(PS.pair_supports.launches == b1,
              "the gather-join branch launched B1")
        text = patterns_text(got)
        check(text == patterns_text(g_got),
              f"multiword push {push}: B1 and the gather-join differ")
        want = mine_spade(kern.window.sequences(), kern.minsup_abs())
        check(text == patterns_text(want),
              f"multiword push {push} differs from the oracle:\n"
              + diff_patterns(want, got))
        cur = {p for p, _ in got}
        if prev is not None:
            entered += len(cur - prev)
            left += len(prev - cur)
            repaired_after_first += kern.stats["repaired_nodes"] - r0
        prev = cur
        print(f"[stream] multiword W={n_words} push {push}: {len(got)} "
              f"patterns byte-identical to the oracle and to the gather-join "
              f"branch; repaired_nodes +{kern.stats['repaired_nodes'] - r0}, "
              f"B1 launches {b1}, engine launches "
              f"{kern.stats['kernel_launches']} (gather-join "
              f"{gath.stats['kernel_launches']})", flush=True)
    check(repaired_after_first > 0, "no node repaired after the first push")
    check(entered > 0 and left > 0,
          f"patterns crossed the border {entered} times in, {left} out")
    print(f"[stream] multiword: {repaired_after_first} nodes repaired after "
          f"the first push on the card; {entered} patterns entered and {left} "
          f"left the frequent set", flush=True)
    del kern, gath, mw_batches

    # 19. shape_buckets=True on the card, against the oracle texts above
    bstats: dict = {}
    got = mine_spade_torch(bms_db, bms_minsup, shape_buckets=True,
                           stats_out=bstats)
    check(patterns_text(got) == bms_text,
          "SPADE with shape_buckets differs from phase 5's oracle result")
    print(f"[buckets] SPADE bms_webview2_like auto: route "
          f"{bstats.get('fused')!r}, {len(got)} patterns byte-identical to "
          f"phase 5's oracle result", flush=True)
    bstats = {}
    first_minsup = abs_minsup(STREAM_MINSUP, len(stream_first))
    got = mine_spam_torch(stream_first, first_minsup, shape_buckets=True,
                          stats_out=bstats)
    check(patterns_text(got) == stream_texts[1],
          "SPAM with shape_buckets differs from the first window's oracle")
    print(f"[buckets] SPAM on phase 17's first batch ({len(stream_first)} "
          f"sequences): {len(got)} patterns byte-identical to the oracle's "
          f"mine of push 1; waves {bstats['waves']}", flush=True)
    bstats = {}
    got_t = mine_tsr_torch(tsr_small_db, 100, 0.5, max_side=None,
                           shape_buckets=True, stats_out=bstats)
    check(rules_text(got_t) == tsr_small_text,
          "TSR with shape_buckets differs from mine_tsr_cpu")
    print(f"[buckets] TSR kosarak_like(scale=0.01) max_side=None: "
          f"{'the resident route' if bstats.get('resident') else 'the host loop'}"
          f", {len(got_t)} rules byte-identical to mine_tsr_cpu", flush=True)
    c_db, c_minsup, c_text = cspade_small
    bstats = {}
    got = mine_cspade_torch(c_db, c_minsup, maxgap=2, maxwindow=5,
                            shape_buckets=True, stats_out=bstats)
    check(patterns_text(got) == c_text,
          "cSPADE with shape_buckets differs from the oracle")
    print(f"[buckets] cSPADE gazelle_like(scale={GAZELLE_SCALES[-1]}): "
          f"{len(got)} patterns byte-identical to the oracle; geometry "
          f"{bstats['geometry']}", flush=True)
    mesh_bms = bms_db   # phase 21 mines it again
    part_inputs.update(kos_vdb=kos_vdb, tsr_small_db=tsr_small_db,
                       bms=(bms_db, bms_minsup))
    del got, got_t, bms_db, stream_first, tsr_small_db, cspade_small
    del kos_vdb

    # 20. prediction scoring over the rule sets of phases 9, 5 and 13
    predict_phase(torch, dev, [predict_sets[k] for k in ("tsr", "spade",
                                                         "spam")])

    # 21. sequence meshes on the card
    tenth: dict = {}
    mesh_phase(torch, mesh_want, single_walls, card, mesh_bms, tenth)
    del mesh_bms

    # 22. class-partitioned mines at full size in this process
    part_walls: dict = {}
    partition_phase(torch, part_inputs, mesh_want, single_walls, card,
                    part_walls)

    # 23. the service over HTTP on the full-size databases above
    (bms_db, bms_minsup), (ms_db, ms_minsup), (gz_db, gz_minsup) = (
        part_inputs[k] for k in ("bms", "msnbc", "gazelle"))
    kos_db = service_dbs.pop("kosarak")   # phase 24 fuses it
    solo = service_phase(torch, card, [
        ("kosarak", kos_db,
         dict(algorithm="TSR_TPU", k="100", minconf="0.5", max_side="2"),
         "rules", predict_sets["tsr"][2], single_walls["tsr"], "b2"),
        ("msnbc", ms_db, dict(algorithm="SPAM_TPU", support=str(ms_minsup)),
         "patterns", predict_sets["spam"][2], single_walls["spam"], "b3"),
        ("gazelle", gz_db, dict(algorithm="SPADE_TPU", support=str(gz_minsup),
                                maxgap="2", maxwindow="5"),
         "patterns", gazelle_payload, single_walls["cspade"], None),
        ("bms", bms_db, dict(algorithm="SPADE_TPU", support=str(bms_minsup)),
         "patterns", predict_sets["spade"][2], single_walls["spade auto"],
         "b1"),
        ("bms", bms_db, dict(algorithm="SPADE_TPU", support=str(bms_minsup)),
         "patterns", None, single_walls["spade auto"], "b1"),
    ], {name: (what, kind, payload, prefixes[:16])
        for name, (what, kind, payload, prefixes) in (
            ("kosarak", predict_sets["tsr"]),
            ("bms", predict_sets["spade"]))})
    del gz_db

    # 24. the warm and fused service
    bms_vdb = build_vertical(bms_db, min_item_support=bms_minsup)
    small_db = part_inputs["tsr_small_db"]
    small_vdb = build_vertical(small_db, min_item_support=1)
    warm_phase(torch, card, (
        bms_db, dict(algorithm="SPADE_TPU", support=str(bms_minsup)),
        predict_sets["spade"][2], "patterns",
        dict(sequences=len(bms_db), items=bms_vdb.n_items,
             words=bms_vdb.n_words)), (
        small_db, dict(algorithm="TSR_TPU", k="100", minconf="0.5"),
        tsr_small_payload, "rules",
        dict(sequences=len(small_db), items=small_vdb.n_items,
             words=small_vdb.n_words, tsr=True)))
    del bms_vdb, small_vdb
    ms_rules = SM.serialize_rules(mine_tsr_torch(ms_db, 100, 0.5,
                                                 max_side=2))
    fusion_phase(torch, card, kos_db, part_inputs["kos_vdb"],
                 predict_sets["tsr"][2], mesh_want["tsr"], ms_db, ms_rules,
                 solo["kosarak"], RULE_HEADLINE[:2])
    # 25. the service on a mesh
    bms_payload = predict_sets["spade"][2]
    del predict_sets
    mesh_service_phase(torch, card, {
        "kos_vdb": part_inputs["kos_vdb"], "tsr": mesh_want["tsr"],
        "bms": (bms_db, bms_minsup), "spade": mesh_want["spade auto"],
        "spade payload": bms_payload,
        "spade wall": single_walls["spade auto"],
        "tenth": (tenth["db"], tenth["payload"], tenth["wall"],
                  tenth["digest"]),
        "part walls": part_walls,
        "world part tsr": tenth.get("world part tsr"),
        "stream texts": stream_spmf, "stream": stream_served,
        "stream batch": stream_shape[0], "stream items": stream_shape[1]})
    del part_inputs, bms_db, kos_db, small_db, ms_db, tenth, stream_spmf

    print(json.dumps({"kernels": [pair_record, rule_record, {
        "name": "extend_prune", "route": "cuda",
        "source": "spark_fsm_tpu_torch/csrc/extend_prune.cu",
        "replaces": "spark_fsm_tpu/ops/pallas_extend.py:172",
        "launches": elaunches, "max_abs_err": eworst,
        "ms": ems, "plain_ms": eplain_ms, "bound_ms": ebound_ms,
        "bound_by": ebound_by, "library_ms": None,
    }]}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
