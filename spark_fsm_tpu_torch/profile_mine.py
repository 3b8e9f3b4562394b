"""Where the main paths' time goes, on one CUDA card.

    python3 -m spark_fsm_tpu_torch.profile_mine [spade] [tsr] [spam] \
        [tsr-resident] [cspade] [stream] [predict] [tsr-partition] \
        [partition-world] [service]

Prints one JSON line per path named (the first seven when none is):
- SPADE: the BMS-WebView-2-shaped database (full size) at minsup 0.1 %
  through both of its routes, in turns: the queue engine (the ``auto``
  route's choice) and the classic engine (``fused="never"``).  For each,
  the host-clock wall of each stage (vertical build, store build, the
  search; medians of three warm mines), the search split into host work
  and waits on the device, and the parent rows (P) of each pair-support
  launch;
- TSR: the Kosarak-shaped database (full size) with k=100, minconf=0.5,
  max_side=2: the stage walls (vertical build, engine set-up, the prep of
  each deepening round, the host loop, waits on the device; medians of
  three warm mines), each rule-support launch's km and candidate count,
  and, from the warm-up mine, how its candidates share rows: per launch
  the distinct X and Y sides and the share of candidates whose X (Y) side
  equals the previous candidate's, which the kernel's staged path reuses;
- SPAM: the MSNBC-shaped database (full size) at minsup 0.5 %: the stage
  walls (vertical build, store build, DFS; medians of three warm mines),
  the DFS split into host work and waits on the device, and the parent
  rows (P) of each extension-count-prune launch;
- TSR's resident-frontier route: the Kosarak-shaped database with k=100,
  minconf=0.5 and no side cap, at full size pinned to the route
  (``resident="always"``) and to the host loop (``"never"``), and at 1 %
  of it through ``auto`` (which takes the route) and pinned to the host
  loop: the vertical build (once a size), then per mine the engine
  set-up, the round's prep, the rest split into waits on the device and
  host work (medians of three warm mines, the routes in turns), and the
  resident waves at each width;
- cSPADE: the Gazelle-shaped database (full size) with maxgap 2,
  maxwindow 5, minsup 0.5 %: the stage walls (vertical build, engine
  set-up, the DFS; medians of three warm mines) and the geometry;
- streaming windows: the MSNBC-shaped database (full size) cut into ten
  micro-batches of 99,000 sequences, a window of five, minsup 0.5 %,
  pushed through the incremental miner and the re-mine miner in turns:
  per push and route the wall, the incremental miner's ``phase_s`` and
  counters, the re-mine's engine route; then the same stream again with
  each push under ``torch.profiler``: per push and route the device's
  busy time and idle share, and the pair-support kernel's device time
  and launches;
- prediction scoring: three full-size rule sets (the Kosarak-shaped TSR
  mine's rules, k=100, minconf=0.5, max_side=2; the BMS-WebView-2-shaped
  SPADE mine's patterns at minsup 0.1 % and the MSNBC-shaped SPAM mine's
  at 0.5 %, both through ``rules_from_patterns``), each built through the
  artifact cache at the ``[predict]`` defaults and scored over 2,050
  prefixes drawn from its database (``predict_prefixes``) in waves of W =
  1, 16 and 64 at m = 8: per W the wave wall split into pack, scoring
  (upload, the scorer's launches, the readback wait; its device part by
  CUDA events) and decode (medians and p99), then the same waves under
  ``torch.profiler``: the device's busy time and idle share and the
  scorer's device ops by time;
- class-partitioned TSR (``tsr-partition``, named only): the
  Kosarak-shaped database at 1 % with k=100, minconf=0.5 and no side cap
  (the rows take the resident route), unpartitioned (``TsrTorch``) and
  through ``TsrPartitioned`` at 2 and 4 parts, one cold mine each on one
  vertical DB: per partition the wall, the candidates evaluated, the
  resident waves and the B2 launches, the floor each slice started from,
  and the exchanges;
- partition rows across cards (``partition-world``, named only; needs
  two cards or more): an NCCL world of one rank a card mines the
  BMS-WebView-2-shaped SPADE (``auto``) and the Kosarak-shaped TSR
  (``max_side=2``) as a plain sequence mesh, at 2 partitions and at one
  partition a rank; per rank and layout the wall (its first mine of each
  database includes nothing but the mine: each rank builds its databases
  first), the B1/B2 launches, the exchanges and their bytes, each text
  held against the one-device mine's;
- the service (``service``, named only): the Kosarak-shaped TSR request
  (k=100, minconf=0.5, max_side=2) and the BMS-WebView-2-shaped SPADE
  request (minsup 0.1 %) through the port's ``serve_background()``, in
  turns with the library call of the same mine and with the engine
  caches emptied before each job: per run the library wall on the main
  thread and on a fresh thread (the Miner mines on its own thread), the
  vertical build alone on each, the engine cache's content fingerprint
  alone, and the job's submit-to-finished wall and ``mine_s`` with the
  client polling ``/status`` every 5 ms and every 250 ms.
Each line also names the tokenizer that ran (``data/fasttok.backend()``);
each mining path's line gives the host functions that take the vertical
build's time (one more build under ``cProfile``: the ten largest by own
time), and carries a ``torch.profiler`` trace of one more warm mine:
device busy time by kernel (the ten largest entries, and every launch of
the port's own kernels) and the device's idle share of the mine's wall.
Needs a CUDA card; raises without one.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

REPS = 3
# prediction scoring: the [predict] section's top-m, the waves timed, and
# the prefixes drawn a rule set
PREDICT_M = 8
PREDICT_WAVES = (1, 16, 64)
PREDICT_PREFIXES = 2048
# the __global__ functions of csrc/*.cu
PORT_KERNELS = ("pair_support_kernel", "rule_staged_kernel", "rule_walk_kernel",
                "extend_lane_kernel", "extend_staged_kernel")


def _median(runs):
    return {k: statistics.median(r[k] for r in runs) for k in runs[0]}


def _device_busy_s(prof) -> float:
    """Seconds the device was busy under ``prof``: the union of its
    kernel, copy and set intervals, so that work overlapping on several
    streams counts once (a sum of per-op times counts it twice)."""
    from torch.autograd import DeviceType

    busy, end = 0, None
    for s, e in sorted(
            (e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA):
        if end is not None and s < end:
            s = end
        if e > s:
            busy += e - s
            end = e
    return busy / 1e9


def _vertical_profile(db, min_item_support: int) -> dict:
    """One ``build_vertical`` under ``cProfile``: its wall and the ten
    functions with the most own time."""
    import cProfile
    import pstats

    from spark_fsm_tpu_torch.data.vertical import build_vertical

    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.runcall(build_vertical, db, min_item_support=min_item_support)
    wall = time.perf_counter() - t0
    st = pstats.Stats(prof).stats
    top = sorted(st.items(), key=lambda kv: -kv[1][2])[:10]
    return {"wall_s": wall, "top_own_s": [
        {"fn": f"{fn[0].rsplit('/', 1)[-1]}:{fn[1]}({fn[2]})",
         "calls": v[1], "own_s": v[2], "cum_s": v[3]} for fn, v in top]}


def _profiled(one_mine):
    """One more warm mine under ``torch.profiler``: its wall, its stages,
    device busy time and the top device ops."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res, eng, stages = one_mine()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = []
    for e in prof.key_averages():
        # device-side events only (kernels, copies): their launching CPU
        # ops report the same time again
        if e.device_type != DeviceType.CUDA:
            continue
        dev_us = e.self_device_time_total
        if dev_us > 0:
            kernels.append((dev_us, e.key, e.count))
    kernels.sort(reverse=True)
    busy = _device_busy_s(prof)
    # the port's own kernels, however small: a path's kernel time is their sum
    port = [{"name": k[:80], "ms": us / 1e3, "count": c} for us, k, c in kernels
            if any(f"::{n}<" in k for n in PORT_KERNELS)]
    return res, eng, {
        "profiled_wall_s": wall, "profiled_stages_s": stages,
        "device_busy_s": busy,
        "device_idle_share": (1 - busy / wall) if busy else None,
        "top_device_ops": [{"name": k[:80], "ms": us / 1e3, "count": c}
                           for us, k, c in kernels[:10]],
        "port_kernels": port,
    }


def spade(dev, card: str) -> dict:
    import torch

    from spark_fsm_tpu_torch.data.synth import bms_webview2_like
    from spark_fsm_tpu_torch.data.vertical import abs_minsup, build_vertical
    from spark_fsm_tpu_torch.models import spade as SP
    from spark_fsm_tpu_torch.models import spade_queue as SQ
    from spark_fsm_tpu_torch.ops import pair_support as PS

    db = bms_webview2_like()
    minsup = abs_minsup(0.001, len(db))
    PS._kernel()  # build outside the timed stages

    waits, pair_rows = [], []

    class Timed(SP.SpadeTorch):
        """The classic engine with its waits on the device's supports timed
        and the parent rows (P) of each pair-support launch recorded."""

        def _supports_dispatch(self, pt, ref, item, iss):
            pair_rows.append(pt.shape[0])
            return super()._supports_dispatch(pt, ref, item, iss)

        def _resolve(self, inflight, stack, results):
            ev = inflight[-1]
            if ev is not None:
                t0 = time.perf_counter()
                ev.synchronize()
                waits.append(time.perf_counter() - t0)
            return super()._resolve(inflight, stack, results)

    class TimedQueue(SQ.QueueSpadeTorch):
        """The queue engine with the parent rows (P) of each wave's
        pair-support launch recorded; it times its own counter waits."""

        def wave(self, c, nb):
            pair_rows.append(2 * nb)
            return super().wave(c, nb)

    def one_mine(engine):
        def run():
            waits.clear()
            pair_rows.clear()
            t0 = time.perf_counter()
            vdb = build_vertical(db, min_item_support=minsup)
            t1 = time.perf_counter()
            eng = engine(vdb, minsup, device=dev)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            res = eng.mine()
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            wait = eng.stats.get("wait_s", sum(waits))
            return res, eng, {"vertical_s": t1 - t0, "store_s": t2 - t1,
                              "search_s": t3 - t2, "wait_s": wait,
                              "host_s": t3 - t2 - wait, "total_s": t3 - t0}
        return run

    vdb = build_vertical(db, min_item_support=minsup)
    if not SQ.queue_eligible(vdb, dev):
        raise RuntimeError("the BMS-shaped mine is not queue-eligible")
    geo = SQ.queue_geometry(vdb.n_sequences, vdb.n_items, vdb.n_words,
                            device=dev)
    routes = {"queue": one_mine(TimedQueue), "classic": one_mine(Timed)}
    for run in routes.values():
        run()  # warm-up: CUDA context, caching allocator, pinned host pool
    runs = {name: [] for name in routes}
    for _ in range(REPS):  # in turns, so both see the same host
        for name, run in routes.items():
            runs[name].append(run()[2])
    out = {"path": "spade", "card": card,
           "device": torch.cuda.get_device_name(dev),
           "sequences": len(db), "minsup": minsup,
           "vertical_profile": _vertical_profile(db, minsup),
           "queue_geometry": {"nb": geo["caps"].nb, "nb_late": geo["nb_late"],
                              "ring": geo["caps"].ring,
                              "ni_pad": geo["ni_pad"]}}
    for name, run in routes.items():
        res, eng, prof = _profiled(run)
        out[name] = {"patterns": len(res), "stats": eng.stats,
                     "pair_launch_rows": list(pair_rows),
                     "reps": len(runs[name]),
                     "median_s": _median(runs[name]), **prof}
        del res, eng
        torch.cuda.empty_cache()
    return out


def tsr(dev, card: str) -> dict:
    import torch

    from spark_fsm_tpu_torch.data.synth import kosarak_like
    from spark_fsm_tpu_torch.data.vertical import build_vertical
    from spark_fsm_tpu_torch.models import tsr as TS
    from spark_fsm_tpu_torch.ops import rule_support as RS

    db = kosarak_like(scale=1.0, fast=True)
    RS._kernel()  # build outside the timed stages

    preps, waits, launches = [], [], []

    class Timed(TS.TsrTorch):
        """The engine with each round's prep and its waits on the device's
        counts timed, and each rule-support launch's (km, candidates)
        recorded."""

        def _prep(self, m):
            t0 = time.perf_counter()
            out = super()._prep(m)
            torch.cuda.synchronize()
            preps.append(time.perf_counter() - t0)
            return out

        def _count_launch(self, L):
            launches.append((L.km, len(L.rows)))
            super()._count_launch(L)

        def _resolve_eval(self, handle):
            t0 = time.perf_counter()
            handle[2].synchronize()
            waits.append(time.perf_counter() - t0)
            return super()._resolve_eval(handle)

    sharing = []

    def record_sharing(take):
        """Wrap the engine's host staging of each launch's candidates to
        record how consecutive candidates share a side (warm-up mine only:
        the counting is host work)."""
        def spy(L, cands):
            xy = take(L, cands)
            h = xy[:len(L.rows)]
            x, y = h[:, 0], h[:, 1]
            sharing.append({
                "km": int(h.shape[2]), "candidates": int(h.shape[0]),
                "distinct_x": len({r.tobytes() for r in x}),
                "distinct_y": len({r.tobytes() for r in y}),
                "same_x_as_prev": float((x[1:] == x[:-1]).all(1).mean()),
                "same_y_as_prev": float((y[1:] == y[:-1]).all(1).mean())})
            return xy
        return spy

    def one_mine(record=False):
        preps.clear()
        waits.clear()
        launches.clear()
        t0 = time.perf_counter()
        vdb = build_vertical(db, min_item_support=1)
        t1 = time.perf_counter()
        eng = Timed(vdb, 100, 0.5, max_side=2, device=dev)
        if record:
            eng._stager.take = record_sharing(eng._stager.take)
        t2 = time.perf_counter()
        res = eng.mine()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        return res, eng, {
            "vertical_s": t1 - t0, "engine_s": t2 - t1,
            "prep_s": sum(preps), "wait_s": sum(waits),
            "host_loop_s": t3 - t2 - sum(preps) - sum(waits),
            "total_s": t3 - t0}

    one_mine(record=True)  # warm-up
    runs = [one_mine()[2] for _ in range(REPS)]
    res, eng, prof = _profiled(one_mine)
    return {"path": "tsr", "card": card,
            "device": torch.cuda.get_device_name(dev),
            "sequences": len(db), "k": 100, "minconf": 0.5, "max_side": 2,
            "vertical_profile": _vertical_profile(db, 1),
            "rules": len(res), "stats": eng.stats,
            "rule_launches_km_candidates": list(launches),
            "rule_launch_sharing": sharing,
            "reps": len(runs), "median_s": _median(runs), **prof}


def spam(dev, card: str) -> dict:
    import torch

    from spark_fsm_tpu_torch.data.synth import msnbc_like
    from spark_fsm_tpu_torch.data.vertical import abs_minsup, build_vertical
    from spark_fsm_tpu_torch.models import spam_bitmap as SM
    from spark_fsm_tpu_torch.ops import extend_prune as EP

    db = msnbc_like(scale=1.0, fast=True)
    minsup = abs_minsup(0.005, len(db))
    EP._kernel()  # build outside the timed stages

    waits, wave_rows = [], []

    class Timed(SM.SpamBitmapTorch):
        """The engine with its waits on each wave's outputs timed and the
        parent rows (P) of each extension-count-prune launch recorded."""

        def _dispatch(self, stack):
            out = super()._dispatch(stack)
            wave_rows.append(out[1].shape[0])
            return out

        def _resolve(self, inflight, stack, results):
            ev = inflight[-1]
            if ev is not None:
                t0 = time.perf_counter()
                ev.synchronize()
                waits.append(time.perf_counter() - t0)
            return super()._resolve(inflight, stack, results)

    def one_mine():
        waits.clear()
        wave_rows.clear()
        t0 = time.perf_counter()
        vdb = build_vertical(db, min_item_support=minsup)
        t1 = time.perf_counter()
        eng = Timed(vdb, minsup, device=dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        res = eng.mine()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        return res, eng, {"vertical_s": t1 - t0, "store_s": t2 - t1,
                          "dfs_s": t3 - t2, "wait_s": sum(waits),
                          "total_s": t3 - t0}

    one_mine()  # warm-up
    runs = [one_mine()[2] for _ in range(REPS)]
    res, eng, prof = _profiled(one_mine)
    return {"path": "spam", "card": card,
            "device": torch.cuda.get_device_name(dev),
            "sequences": len(db), "minsup": minsup, "patterns": len(res),
            "vertical_profile": _vertical_profile(db, minsup),
            "node_batch": eng.node_batch, "stats": eng.stats,
            "wave_launch_rows": list(wave_rows),
            "reps": len(runs), "median_s": _median(runs), **prof}


def tsr_resident(dev, card: str) -> dict:
    import torch

    from spark_fsm_tpu_torch.data.synth import kosarak_like
    from spark_fsm_tpu_torch.data.vertical import build_vertical
    from spark_fsm_tpu_torch.models import tsr as TS
    from spark_fsm_tpu_torch.ops import rule_support as RS

    RS._kernel()  # build outside the timed stages
    preps, widths = [], []

    class Timed(TS.TsrTorch):
        """The engine with each round's prep timed and the width of each
        resident wave recorded."""

        def _prep(self, m):
            t0 = time.perf_counter()
            out = super()._prep(m)
            torch.cuda.synchronize()
            preps.append(time.perf_counter() - t0)
            return out

    plain_wave = TS.RF.wave

    def wave(c, p1, s1, sup, num, den, k, ms, nb, *rest):
        widths.append(nb)
        return plain_wave(c, p1, s1, sup, num, den, k, ms, nb, *rest)

    out = {"path": "tsr-resident", "card": card,
           "device": torch.cuda.get_device_name(dev), "k": 100,
           "minconf": 0.5, "max_side": None}
    for scale, routes in ((1.0, (("full_always", "always"),
                                 ("full_never", "never"))),
                          (0.01, (("one_percent_auto", "auto"),
                                  ("one_percent_never", "never")))):
        db = kosarak_like(scale=scale, fast=True)
        t0 = time.perf_counter()
        vdb = build_vertical(db, min_item_support=1)
        vertical_s = time.perf_counter() - t0

        def one_mine(resident):
            preps.clear()
            widths.clear()
            t0 = time.perf_counter()
            eng = Timed(vdb, 100, 0.5, max_side=None, resident=resident,
                        device=dev)
            t1 = time.perf_counter()
            res = eng.mine()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            wait = eng.stats.get("wait_s", 0.0)
            return res, eng, {
                "engine_s": t1 - t0, "prep_s": sum(preps), "wait_s": wait,
                "host_s": t2 - t1 - sum(preps) - wait, "mine_s": t2 - t0}

        TS.RF.wave = wave
        try:
            runs = {name: [] for name, _ in routes}
            for name, resident in routes:
                one_mine(resident)  # warm-up
            for _ in range(REPS):
                for name, resident in routes:
                    runs[name].append(one_mine(resident)[2])
            for name, resident in routes:
                res, eng, prof = _profiled(lambda: one_mine(resident))
                out[name] = {
                    "sequences": len(db), "resident_option": resident,
                    "vertical_s": vertical_s, "rules": len(res),
                    "stats": eng.stats,
                    "waves_by_width": {str(w): widths.count(w)
                                       for w in set(widths)},
                    "reps": REPS, "median_s": _median(runs[name]), **prof}
        finally:
            TS.RF.wave = plain_wave
        del db, vdb, res, eng
        torch.cuda.empty_cache()
    return out


def cspade(dev, card: str) -> dict:
    import torch

    from spark_fsm_tpu_torch.data.synth import gazelle_like
    from spark_fsm_tpu_torch.data.vertical import abs_minsup, build_vertical
    from spark_fsm_tpu_torch.models import spade_constrained as SC

    db = gazelle_like(scale=1.0, fast=True)
    minsup = abs_minsup(0.005, len(db))

    def one_mine():
        t0 = time.perf_counter()
        vdb = build_vertical(db, min_item_support=minsup)
        t1 = time.perf_counter()
        eng = SC.ConstrainedSpadeTorch(vdb, minsup, maxgap=2, maxwindow=5,
                                       device=dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        res = eng.mine()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        return res, eng, {"vertical_s": t1 - t0, "engine_s": t2 - t1,
                          "dfs_s": t3 - t2, "total_s": t3 - t0}

    one_mine()  # warm-up
    runs = [one_mine()[2] for _ in range(REPS)]
    res, eng, prof = _profiled(one_mine)
    return {"path": "cspade", "card": card,
            "device": torch.cuda.get_device_name(dev),
            "sequences": len(db), "minsup": minsup, "maxgap": 2,
            "maxwindow": 5, "patterns": len(res),
            "geometry": {"dtype": str(eng.dtype), "chunk": eng.chunk,
                         "node_batch": eng.node_batch,
                         "pool_slots": eng.pool_slots,
                         "pipeline_depth": eng.pipeline_depth},
            "stats": eng.stats, "reps": len(runs),
            "median_s": _median(runs), **prof}


def _traced_call(fn):
    """``fn()`` under ``torch.profiler``: its result, its wall, the
    device's busy time and idle share over it, and the pair-support
    kernel's device time and launch count."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    b1_us = 0.0
    b1_n = 0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        if "::pair_support_kernel<" in e.key:
            b1_us += e.self_device_time_total
            b1_n += e.count
    busy = _device_busy_s(prof)
    return res, {"wall_s": wall, "device_busy_s": busy,
                 "device_idle_share": 1 - busy / wall,
                 "pair_support_ms": b1_us / 1e3,
                 "pair_support_launches": b1_n}


def stream(dev, card: str) -> dict:
    import torch

    from spark_fsm_tpu_torch.data.synth import msnbc_like
    from spark_fsm_tpu_torch.models.spade import mine_spade_torch
    from spark_fsm_tpu_torch.ops import pair_support as PS
    from spark_fsm_tpu_torch.streaming import (
        IncrementalWindowMiner, WindowMiner)
    from spark_fsm_tpu_torch.utils.canonical import patterns_text

    n_push, keep, rel = 10, 5, 0.005
    db = msnbc_like(scale=1.0, fast=True)
    per = len(db) // n_push
    batches = [db[i * per:(i + 1) * per if i < n_push - 1 else len(db)]
               for i in range(n_push)]
    del db
    PS._kernel()  # build outside the timed pushes

    def miners(routes):
        def remine(seqs, minsup):
            st = {}
            res = mine_spade_torch(seqs, minsup, shape_buckets=True,
                                   device=dev, stats_out=st)
            routes.append(st.get("fused"))
            return res

        return (IncrementalWindowMiner(rel, max_batches=keep, device=dev),
                WindowMiner(rel, max_batches=keep, mine=remine, device=dev))

    counters = ("repaired_nodes", "sweep_candidates", "kernel_launches",
                "tracked_nodes", "patterns")
    routes: list = []
    inc, rem = miners(routes)
    pushes = []
    for batch in batches:  # the two routes in turns, unprofiled
        before = {k: inc.stats[k] for k in counters}
        t0 = time.perf_counter()
        got = inc.push(batch)
        torch.cuda.synchronize()
        inc_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = rem.push(batch)
        torch.cuda.synchronize()
        rem_s = time.perf_counter() - t0
        if patterns_text(got) != patterns_text(want):
            raise RuntimeError(f"push {len(pushes) + 1}: the routes differ")
        pushes.append({
            "incremental_s": inc_s, "remine_s": rem_s,
            "phase_s": inc.stats["phase_s"],
            "delta": {k: inc.stats[k] - before[k] for k in counters[:3]},
            "tracked_nodes": inc.stats["tracked_nodes"],
            "patterns": inc.stats["patterns"],
            "store_cache_bytes": inc.stats["store_cache_bytes"],
            "remine_route": routes[-1]})
    traced_routes: list = []
    inc, rem = miners(traced_routes)
    for rec, batch in zip(pushes, batches):  # again, each push traced
        _, rec["incremental_trace"] = _traced_call(lambda: inc.push(batch))
        _, rec["remine_trace"] = _traced_call(lambda: rem.push(batch))
    return {"path": "stream", "card": card,
            "device": torch.cuda.get_device_name(dev),
            "pushes": n_push, "keep": keep, "batch_sequences": per,
            "min_support": rel, "push": pushes}


def predict_prefixes(db, seed: int, n: int = PREDICT_PREFIXES) -> list:
    """``n`` observed prefixes drawn from the database's own sequences
    (the distinct items of the first j itemsets of a random sequence, j
    random), then the empty prefix and one item absent from the
    database."""
    rng = np.random.default_rng(seed)
    out = []
    for s in rng.integers(0, len(db), n):
        seq = db[int(s)]
        j = int(rng.integers(1, len(seq) + 1))
        out.append(sorted({i for st in seq[:j] for i in st}))
    absent = 1 + max(max(max(st) for st in seq) for seq in db)
    return out + [[], [absent]]


def depth_groups(prefixes, depth_floor: int) -> dict:
    """Prefix indices by the artifact depth the service builds for them
    (``predictor.predict_rules``' ``depth_need``)."""
    from spark_fsm_tpu_torch.ops.rule_trie import _next_pow2

    groups: dict = {}
    for i, p in enumerate(prefixes):
        d = max(depth_floor, _next_pow2(max(1, len(p))))
        groups.setdefault(d, []).append(i)
    return dict(sorted(groups.items()))


def timed_wave(trie, wave, m: int):
    """One wave through ``score_wave``'s stages: its rows and the times
    of the pack (s), the scoring (s: the prefix upload, the scorer's
    launches and the wait for the readback), the device's part of it
    (ms, CUDA events around the upload and the scorer) and the decode
    (s)."""
    import torch

    from spark_fsm_tpu_torch.models._common import to_device, to_host
    from spark_fsm_tpu_torch.ops import rule_trie as RT

    dev = trie.ante_tok.device
    M = RT._next_pow2(max(int(m), 1))
    t0 = time.perf_counter()
    q = RT.pack_wave(trie, wave)
    t1 = time.perf_counter()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    outs = RT.score_device(trie, to_device(q, dev), M)
    b.record()
    host, ev = to_host(outs)
    if ev is not None:
        ev.synchronize()
    t2 = time.perf_counter()
    rows = RT.decode_wave(trie, len(wave), m, M, *(h.numpy() for h in host))
    t3 = time.perf_counter()
    return rows, {"pack_s": t1 - t0, "device_ms": a.elapsed_time(b),
                  "score_s": t2 - t1, "decode_s": t3 - t2,
                  "wall_s": t3 - t0}


def wave_summary(recs) -> dict:
    """Median and p99 of each stage over a list of ``timed_wave`` times."""
    out = {}
    for k in recs[0]:
        v = np.asarray([r[k] for r in recs])
        out[k] = {"median": float(np.median(v)),
                  "p99": float(np.percentile(v, 99))}
    return out


def predict_rule_sets(dev) -> list:
    """The three full-size mines whose output prediction serves:
    ``(name, kind, payload, prefixes)`` each."""
    from spark_fsm_tpu_torch.data.synth import (
        bms_webview2_like, kosarak_like, msnbc_like)
    from spark_fsm_tpu_torch.data.vertical import abs_minsup
    from spark_fsm_tpu_torch.models.spade import mine_spade_torch
    from spark_fsm_tpu_torch.models.spam_bitmap import mine_spam_torch
    from spark_fsm_tpu_torch.models.tsr import mine_tsr_torch
    from spark_fsm_tpu_torch.service import model

    sets = []
    db = kosarak_like(scale=1.0, fast=True)
    rules = mine_tsr_torch(db, 100, 0.5, max_side=2, device=dev)
    sets.append(("kosarak_like TSR k=100", "rules",
                 model.serialize_rules(rules), predict_prefixes(db, 1)))
    db = bms_webview2_like()
    pats = mine_spade_torch(db, abs_minsup(0.001, len(db)), device=dev)
    sets.append(("bms_webview2_like SPADE minsup 0.1 %", "patterns",
                 model.serialize_patterns(pats), predict_prefixes(db, 2)))
    db = msnbc_like(scale=1.0, fast=True)
    pats = mine_spam_torch(db, abs_minsup(0.005, len(db)), device=dev)
    sets.append(("msnbc_like SPAM minsup 0.5 %", "patterns",
                 model.serialize_patterns(pats), predict_prefixes(db, 3)))
    return sets


def predict(dev, card: str) -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from spark_fsm_tpu_torch.ops import rule_trie as RT
    from spark_fsm_tpu_torch.service import model
    from spark_fsm_tpu_torch.service import predictor as PR

    PR.configure({})   # the [predict] defaults
    cfg = dict(PR._cfg)
    out = []
    for name, kind, payload, prefixes in predict_rule_sets(dev):
        rules = (RT.rules_from_patterns(model.deserialize_patterns(payload))
                 if kind == "patterns" else model.deserialize_rules(payload))
        groups = depth_groups(prefixes, cfg["depth_floor"])
        depth, idx = next(iter(groups.items()))  # the floor's, the bulk
        trie = PR._cache(dev).get_or_build(
            RT.rules_digest(payload), depth, lambda: rules,
            cfg["lanes_floor"])
        rec = {"rule_set": name, "rules": len(rules), "lanes": trie.lanes,
               "F": trie.F, "D": trie.D, "nbytes": trie.nbytes(),
               "prefixes": len(idx),
               "prefixes_by_depth": {d: len(v) for d, v in groups.items()},
               "waves": {}}
        for W in PREDICT_WAVES:
            waves = [[prefixes[i] for i in idx[k:k + W]]
                     for k in range(0, len(idx), W)]
            timed_wave(trie, waves[0], PREDICT_M)   # warm the allocators
            recs = [timed_wave(trie, w, PREDICT_M)[1] for w in waves]
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for w in waves:
                    RT.score_wave(trie, w, PREDICT_M)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            ops = []
            for e in prof.key_averages():
                if e.device_type != DeviceType.CUDA:
                    continue
                if e.self_device_time_total > 0:
                    ops.append((e.self_device_time_total, e.key, e.count))
            ops.sort(reverse=True)
            busy = _device_busy_s(prof)
            rec["waves"][W] = {
                "count": len(waves), "stages": wave_summary(recs),
                "traced_wall_s": wall, "device_busy_s": busy,
                "device_busy_share": busy / wall,
                "device_idle_share": 1 - busy / wall,
                "device_ops": [{"name": k[:80], "ms": us / 1e3, "count": c}
                               for us, k, c in ops[:12]]}
        out.append(rec)
    return {"path": "predict", "card": card,
            "device": torch.cuda.get_device_name(dev), "m": PREDICT_M,
            "config": cfg, "sets": out}


def tsr_partition(dev, card: str) -> dict:
    import torch

    from spark_fsm_tpu_torch.data.synth import kosarak_like
    from spark_fsm_tpu_torch.data.vertical import build_vertical
    from spark_fsm_tpu_torch.models import tsr as TS
    from spark_fsm_tpu_torch.ops import rule_support as RS

    RS._kernel()  # build outside the timed mines
    vdb = build_vertical(kosarak_like(scale=0.01, fast=True),
                         min_item_support=1)
    out = {"path": "tsr-partition", "card": card,
           "device": torch.cuda.get_device_name(dev), "scale": 0.01,
           "k": 100, "minconf": 0.5, "max_side": None}
    for parts in (1, 2, 4):
        if parts == 1:
            eng = TS.TsrTorch(vdb, 100, 0.5, max_side=None, device=dev)
            engines = {0: eng}
        else:
            eng = TS.TsrPartitioned(vdb, 100, 0.5, parts=parts,
                                    max_side=None, device=dev)
            engines = eng.engines
        per = {p: {"wall_s": 0.0, "floors": [], "b2": 0} for p in engines}
        for p, e in engines.items():
            def timed(m, *args, _inner=e._mine_restricted, _p=p, **kwargs):
                per[_p]["floors"].append(kwargs.get("floor", 1))
                before = RS.rule_supports.launches
                t0 = time.perf_counter()
                res = _inner(m, *args, **kwargs)
                torch.cuda.synchronize()
                per[_p]["wall_s"] += time.perf_counter() - t0
                per[_p]["b2"] += RS.rule_supports.launches - before
                return res
            e._mine_restricted = timed
        t0 = time.perf_counter()
        rules = eng.mine()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for p, e in engines.items():
            per[p].update({key: e.stats.get(key, 0) for key in (
                "evaluated", "resident_rounds", "resident_waves",
                "kernel_launches")})
        out[f"parts_{parts}"] = {
            "wall_s": wall, "rules": len(rules),
            "exchanges": eng.stats.get("partition_exchanges", 0),
            "imbalance": eng.stats.get("partition_imbalance", 1.0),
            "evaluated": sum(r["evaluated"] for r in per.values()),
            "per_part": {str(p): r for p, r in per.items()}}
        del eng, engines
        torch.cuda.empty_cache()
    return out


def _world_mines(mesh, want: dict) -> dict:
    """``partition-world``'s rank: every mine at every layout, each text
    held against the one-device digest in ``want``."""
    import hashlib

    import torch

    from spark_fsm_tpu_torch.data.synth import bms_webview2_like, kosarak_like
    from spark_fsm_tpu_torch.data.vertical import abs_minsup
    from spark_fsm_tpu_torch.models.spade import mine_spade_torch
    from spark_fsm_tpu_torch.models.tsr import mine_tsr_torch
    from spark_fsm_tpu_torch.ops import pair_support as PS
    from spark_fsm_tpu_torch.ops import rule_support as RS
    from spark_fsm_tpu_torch.parallel.mesh import all_reduce_sum
    from spark_fsm_tpu_torch.utils.canonical import patterns_text, rules_text

    bms, kos = bms_webview2_like(), kosarak_like(scale=1.0, fast=True)
    minsup = abs_minsup(0.001, len(bms))
    # the first collective sets the communicator up: not a mine's
    all_reduce_sum(torch.zeros(1, dtype=torch.int32, device=mesh.device),
                   mesh)
    mines = {
        "spade": lambda **kw: patterns_text(mine_spade_torch(
            bms, minsup, mesh=mesh, **kw)),
        "tsr": lambda **kw: rules_text(mine_tsr_torch(
            kos, 100, 0.5, max_side=2, mesh=mesh, **kw))}
    out = {}
    for parts in sorted({0, 2, mesh.size}):
        if parts and mesh.size % parts:
            continue
        for name, mine in mines.items():
            st: dict = {}
            mesh.reset_counters()
            before = (PS.pair_supports.launches, RS.rule_supports.launches)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            text = mine(partition_parts=parts, stats_out=st)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if hashlib.sha256(text.encode()).hexdigest() != want[name]:
                raise AssertionError(f"rank {mesh.rank}: {name} at "
                                     f"{parts} parts differs from one card")
            out[f"{name} parts={parts}"] = {
                "wall_s": wall,
                "b1": PS.pair_supports.launches - before[0],
                "b2": RS.rule_supports.launches - before[1],
                "world_all_reduces": mesh.reduce_stats()["all_reduces"],
                "exchanges": st.get("partition_exchanges", 0),
                "cross_bytes": st.get("partition_cross_bytes", 0)}
    return out


def partition_world(dev, card: str) -> dict:
    import hashlib

    import torch

    from spark_fsm_tpu_torch.data.synth import bms_webview2_like, kosarak_like
    from spark_fsm_tpu_torch.data.vertical import abs_minsup
    from spark_fsm_tpu_torch.models.spade import mine_spade_torch
    from spark_fsm_tpu_torch.models.tsr import mine_tsr_torch
    from spark_fsm_tpu_torch.ops import pair_support as PS
    from spark_fsm_tpu_torch.ops import rule_support as RS
    from spark_fsm_tpu_torch.parallel.launch import spawn_world
    from spark_fsm_tpu_torch.utils.canonical import patterns_text, rules_text

    n = torch.cuda.device_count()
    if n < 2:
        raise SystemExit(f"partition-world needs two cards or more, found {n}")
    PS._kernel(), RS._kernel()   # built once, before the ranks
    bms = bms_webview2_like()
    one = {}
    t0 = time.perf_counter()
    text = patterns_text(mine_spade_torch(bms, abs_minsup(0.001, len(bms))))
    one["spade"] = (hashlib.sha256(text.encode()).hexdigest(),
                    time.perf_counter() - t0)
    kos = kosarak_like(scale=1.0, fast=True)
    t0 = time.perf_counter()
    text = rules_text(mine_tsr_torch(kos, 100, 0.5, max_side=2))
    one["tsr"] = (hashlib.sha256(text.encode()).hexdigest(),
                  time.perf_counter() - t0)
    del bms, kos
    t0 = time.perf_counter()
    ranks = spawn_world(_world_mines, n, "nccl", "cuda",
                        ({k: v[0] for k, v in one.items()},),
                        timeout_s=1800)
    return {"path": "partition-world", "card": card, "cards": n,
            "device": torch.cuda.get_device_name(dev),
            "one_card_s": {k: v[1] for k, v in one.items()},
            "world_s": time.perf_counter() - t0, "ranks": ranks}


def service(dev, card: str) -> dict:
    import threading
    import urllib.parse
    import urllib.request

    import torch

    from spark_fsm_tpu_torch.data.synth import bms_webview2_like, kosarak_like
    from spark_fsm_tpu_torch.data.vertical import abs_minsup, build_vertical
    from spark_fsm_tpu_torch.models.spade import mine_spade_torch
    from spark_fsm_tpu_torch.models.tsr import mine_tsr_torch
    from spark_fsm_tpu_torch.service import devcache, sources
    from spark_fsm_tpu_torch.service.app import serve_background

    kos = kosarak_like(scale=1.0, fast=True)
    bms = bms_webview2_like()
    bms_minsup = abs_minsup(0.001, len(bms))
    dbs = {"kosarak": kos, "bms": bms}
    sources.register("PROFILE", lambda req, store: dbs[req.param("db")])
    work = {
        "kosarak TSR k=100 max_side=2": (
            "kosarak", dict(algorithm="TSR_TPU", k="100", minconf="0.5",
                            max_side="2"),
            lambda: mine_tsr_torch(kos, 100, 0.5, max_side=2, device=dev),
            lambda: build_vertical(kos, min_item_support=1)),
        "bms SPADE minsup 0.1 %": (
            "bms", dict(algorithm="SPADE_TPU", support=str(bms_minsup)),
            lambda: mine_spade_torch(bms, bms_minsup, device=dev),
            lambda: build_vertical(bms, min_item_support=bms_minsup)),
    }

    def timed(fn, thread: bool) -> float:
        t0 = time.perf_counter()
        if thread:
            th = threading.Thread(target=fn)
            th.start()
            th.join()
        else:
            fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0
    srv = serve_background(device=dev)
    port = srv.server_port

    def post(endpoint, **params):
        data = urllib.parse.urlencode(params).encode()
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{endpoint}",
                                    data=data, timeout=600) as resp:
            return json.loads(resp.read().decode())

    n = [0]

    def job(name, params, poll_s):
        for cache in (devcache.spade_engine_cache, devcache.tsr_engine_cache):
            cache.clear()
        n[0] += 1
        uid = f"profile-{n[0]}"
        t0 = time.perf_counter()
        post("/train", uid=uid, source="PROFILE", db=name, **params)
        while True:
            st = post(f"/status/{uid}")
            if st["status"] in ("finished", "failure"):
                break
            time.sleep(poll_s)
        wall = time.perf_counter() - t0
        if st["status"] != "finished":
            raise RuntimeError(f"service job failed: {st['data']}")
        return wall, json.loads(st["data"]["stats"])["mine_s"]

    out = {}
    try:
        for what, (name, params, lib, vertical) in work.items():
            lib()   # warm-up: kernels built, allocator warm
            torch.cuda.synchronize()
            runs = []
            for rep in range(2):
                order = (("lib", "thread", 0.005, 0.25) if rep == 0
                         else (0.25, 0.005, "thread", "lib"))
                row = {}
                for step in order:
                    if step in ("lib", "thread"):
                        sfx = "" if step == "lib" else "_thread"
                        row["library" + sfx + "_s"] = timed(lib, sfx != "")
                        row["vertical" + sfx + "_s"] = timed(vertical,
                                                             sfx != "")
                        continue
                    wall, mine_s = job(name, params, step)
                    row[f"job_s_poll_{int(step * 1000)}ms"] = wall
                    row[f"mine_s_poll_{int(step * 1000)}ms"] = mine_s
                t0 = time.perf_counter()
                devcache.db_fingerprint(dbs[name])
                row["fingerprint_s"] = time.perf_counter() - t0
                runs.append(row)
            out[what] = runs
    finally:
        srv.master.shutdown()
        srv.shutdown()
        srv.server_close()
        sources.SOURCES.pop("PROFILE", None)
    return {"path": "service", "card": card,
            "device": torch.cuda.get_device_name(dev), "runs": out}


PATHS = {"spade": spade, "tsr": tsr, "spam": spam,
         "tsr-resident": tsr_resident, "cspade": cspade, "stream": stream,
         "predict": predict}
# named only: a four-part mine takes minutes; a world needs several cards
EXTRA_PATHS = {"tsr-partition": tsr_partition,
               "partition-world": partition_world, "service": service}


def main(names=None) -> list:
    from spark_fsm_tpu_torch.device import resolve_device

    names = list(names or PATHS)
    paths = {**PATHS, **EXTRA_PATHS}
    unknown = [n for n in names if n not in paths]
    if unknown:
        raise SystemExit(f"unknown path(s) {unknown}; choose from {list(paths)}")
    dev = resolve_device(None)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    from spark_fsm_tpu_torch.data import fasttok

    out = []
    for name in names:
        out.append(paths[name](dev, card))
        out[-1]["tokenizer"] = fasttok.backend()
        print(json.dumps(out[-1]), flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
