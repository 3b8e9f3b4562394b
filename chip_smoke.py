#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``spark_fsm_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, one printed line each (any failure raises and exits non-zero):
  1. the card: ``nvidia-smi`` name and power limit, torch's device name;
  2. build every kernel of the main path from ``csrc/`` with nvcc (sm_90a);
  3. the pair-support kernel against its plain PyTorch version on the card,
     exact equality, W in {1, 2, 3} on ragged shapes, plus the candidate
     extraction of ``batch_supports``;
  4. the kernel and its plain version timed with CUDA events at the
     headline launch (P=2048, NI=360, S=77,504, W=1) and at the main
     path's first launch (P=720), beside the least time the card could
     take for the same work;
  5. the main path at full data size: ``mine_spade_torch`` on a
     BMS-WebView-2-shaped database (77,500 sequences) at minsup 0.1 %,
     byte-identical to the CPU oracle, with the kernel's launches counted;
  6. a multiword mine (W >= 2) against the oracle.
Then one JSON line with every kernel's numbers, and as the last line
``{"ok": true, "device": {...}}``.  Without a CUDA card it exits non-zero
and prints no result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

# Card peaks for the bound (H100 SXM data sheet, as in the repository's
# measurement notes): 3.35 TB/s of device memory, and int32 work on the CUDA
# cores at 64 lanes per SM per clock — a quarter of the 67 TFLOP/s fp32
# rate, which counts 128 lanes and two operations per fused multiply-add.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 4

# (P, NI, S, W) of the timed launches: the headline launch, and the main
# path's first one (its first batch: the 360 frequent items as parents,
# plain and s-ext-transformed rows)
HEADLINE = (2048, 360, 77504, 1)
MAIN_LAUNCH = (720, 360, 77504, 1)


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    from spark_fsm_tpu_torch.data.synth import bms_webview2_like, synthetic_db
    from spark_fsm_tpu_torch.data.vertical import abs_minsup, build_vertical
    from spark_fsm_tpu_torch.models.oracle import mine_spade
    from spark_fsm_tpu_torch.models.spade import mine_spade_torch
    from spark_fsm_tpu_torch.ops import _build
    from spark_fsm_tpu_torch.ops import pair_support as PS
    from spark_fsm_tpu_torch.utils.canonical import diff_patterns, patterns_text

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # 1. the card
    card = smi("name,power.limit")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f"[card] nvidia-smi: {card} | torch: {kind} x{count} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    # 2. build (one nvcc per source; this slice has one kernel)
    t0 = time.perf_counter()
    lib_path = _build.build("pair_support")
    PS._kernel()
    build_s = time.perf_counter() - t0
    usage = [ln.split("ptxas info    :")[-1].strip()
             for ln in _build.build_log("pair_support").splitlines()
             if "registers" in ln]
    check(bool(usage), "the build printed no ptxas register report")
    print(f"[build] pair_support.cu -> {os.path.basename(lib_path)} in "
          f"{build_s:.3f} s; ptxas: {usage}", flush=True)

    # 3. kernel == plain version, exactly, on ragged shapes
    rng = np.random.default_rng(0)
    worst = 0
    timed = {}
    for (P, NI, S, W) in ((130, 77, 1001, 1), (67, 129, 517, 2),
                          (3, 5, 4099, 3), MAIN_LAUNCH, HEADLINE):
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
        if (P, NI, S, W) in (MAIN_LAUNCH, HEADLINE):
            timed[(P, NI, S, W)] = (pt, items)

    # 4. timing at the headline launch and at the main path's first one
    # the kernels line reports the headline launch, timed last
    for shape in (MAIN_LAUNCH, HEADLINE):
        pt, items = timed.pop(shape)
        P, NI, S, W = shape
        ms = time_ms(lambda: PS.pair_supports(pt, items, NI, n_words=W), 3, 20)
        plain_ms = time_ms(
            lambda: PS.pair_supports_plain(pt, items, NI, n_words=W), 1, 10)
        bound_ms, bound_by = pair_bound_ms(P, NI, S, W)
        clocks = smi("clocks.sm,power.draw,temperature.gpu")
        print(f"[time] pair_supports P={P} NI={NI} S={S} W={W}: kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}, {100 * bound_ms / ms:.1f} % of it reached), "
              f"library: none (no single PyTorch call counts 'any' per "
              f"sequence); after timing nvidia-smi sm clock, power, temp: "
              f"{clocks}", flush=True)
        del pt, items
    torch.cuda.empty_cache()

    # 5. the main path at full data size
    t0 = time.perf_counter()
    db = bms_webview2_like()
    gen_s = time.perf_counter() - t0
    minsup = abs_minsup(0.001, len(db))
    vdb = build_vertical(db, min_item_support=minsup)
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
    check(launches > 0, "the main path launched the pair-support kernel 0 times")
    t0 = time.perf_counter()
    got_warm = mine_spade_torch(db, minsup)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = mine_spade(db, minsup)
    oracle_s = time.perf_counter() - t0
    text = patterns_text(want)
    check(patterns_text(got) == text, "main-path mine differs from the oracle:\n"
          + diff_patterns(want, got))
    check(patterns_text(got_warm) == text, "warm mine differs from the oracle")
    print(f"[mine] bms_webview2_like: {len(db)} sequences, {vdb.n_items} "
          f"frequent items, W={vdb.n_words}, minsup {minsup}: {len(got)} "
          f"patterns byte-identical to the oracle; cold {cold_s:.3f} s, "
          f"warm {warm_s:.3f} s, pair-support launches {launches}, "
          f"candidates {stats['candidates']}, engine launches "
          f"{stats['kernel_launches']}, max_memory_allocated {peak} B; "
          f"host: generator {gen_s:.1f} s, oracle {oracle_s:.1f} s",
          flush=True)
    del db, got, got_warm, want, vdb
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

    print(json.dumps({"kernels": [{
        "name": "pair_support", "route": "cuda",
        "source": "spark_fsm_tpu_torch/csrc/pair_support.cu",
        "replaces": "spark_fsm_tpu/ops/pallas_support.py:202",
        "launches": launches, "max_abs_err": worst,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None,
    }]}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
