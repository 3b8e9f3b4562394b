"""Port tests that need a CUDA card (marker ``cuda``); they skip elsewhere.

On the machine with the card (which has no jax, so the repository's
conftest is left out):

    python3 -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Each kernel (B1 pair supports, on each of its tiles and with its
live-row hint too; B2 rule supports; B3 extension count + prune) is held
against its plain version exactly, and the engines' mines
(SPADE's classic, queue and dense engines, TSR, SPAM) against the port's
CPU oracles, with the kernels' launches counted.  One queue wave, one
dense level and TSR's resident waves (wide and narrow) run under
``torch.cuda.set_sync_debug_mode("error")``: their bodies never wait on the
host.  TSR's resident-frontier route launches B2 once a wave and equals
the CPU mine; the constrained SPADE engine on the card equals its CPU run,
and launches its window-mask kernel (held against its plain version) and
B1 once each a node batch.
The incremental window miner launches B1 once a swept level and equals
the same stream on the CPU, the oracle and the re-mine miner after every
push; its sweep's dispatch runs under sync-debug "error" too.  The rule
trie's scorer on the card equals its CPU run, its wave up to the one
readback makes no host sync, and broker threads keep the trie's device.
Sequence meshes on the one card: a 1-rank NCCL world's SPADE (queue and
classic), SPAM and TSR mines equal the one-device mines, its queue waves
with their all-reduce make no host sync, and a 2-rank gloo world whose
ranks share the card equals the one-device mines too.  Two class
partitions of each engine, mined in turn on the card, launch the route's
kernel and equal the one-device mine.  The fusion broker's fused store
(two jobs' real rows, zero rows up to ``m_pad``, one all-ones row) gives
B2 equal to its plain version, and two TSR jobs fused on the card equal
their solo mines; after a prewarm at the mine's envelope, a first mine in
the process records only enumerated keys and builds or loads no kernel
library (``utils/jitcache.compile_counts``), and an injected OOM on a
kernel launch, direct or the broker's fused one, halves it with the rules
unchanged.
"""

import numpy as np
import pytest
import torch

from spark_fsm_tpu_torch.data.synth import synthetic_db
from spark_fsm_tpu_torch.data.vertical import abs_minsup
from spark_fsm_tpu_torch.models.oracle import mine_spade
from spark_fsm_tpu_torch.data.vertical import build_vertical
from spark_fsm_tpu_torch.models.spade import mine_spade_torch
from spark_fsm_tpu_torch.models.spade_fused import FusedCaps, FusedSpadeTorch
from spark_fsm_tpu_torch.models.spade_queue import QueueCaps, QueueSpadeTorch
from spark_fsm_tpu_torch.models.spade_constrained import mine_cspade_torch
from spark_fsm_tpu_torch.models.spam_bitmap import mine_spam_torch
from spark_fsm_tpu_torch.models.tsr import (
    TsrTorch, mine_tsr_cpu, mine_tsr_torch, resident_counters)
from spark_fsm_tpu_torch.ops import extend_prune as EP
from spark_fsm_tpu_torch.ops import maxstart_masks as MM
from spark_fsm_tpu_torch.ops import maxstart_torch as MT
from spark_fsm_tpu_torch.ops import pair_support as PS
from spark_fsm_tpu_torch.ops import ragged_batch as RB
from spark_fsm_tpu_torch.ops import resident_frontier as RF
from spark_fsm_tpu_torch.ops import rule_support as RS
from spark_fsm_tpu_torch.utils.canonical import (
    diff_patterns, patterns_text, rules_text)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _words(rng, *shape):
    w = (rng.integers(0, 2**32, shape, dtype=np.uint32)
         & rng.integers(0, 2**32, shape, dtype=np.uint32))
    w |= rng.integers(0, 2, shape, dtype=np.uint32) << np.uint32(31)
    return torch.from_numpy(w.view(np.int32))


@pytest.mark.parametrize("P,NI,S,W", [(1, 1, 1, 1), (64, 64, 32, 1),
                                      (130, 77, 1001, 1), (67, 129, 517, 2),
                                      (3, 5, 4099, 3), (9, 70, 40, 40),
                                      (5, 66, 7, 100)])
def test_kernel_equals_plain(card, P, NI, S, W):
    rng = np.random.default_rng(P * 7919 + S)
    pt = _words(rng, P, S * W).to(card)
    items = _words(rng, NI + 3, S * W).to(card)
    before = PS.pair_supports.launches
    got = PS.pair_supports(pt, items, NI, n_words=W)
    torch.cuda.synchronize()
    assert PS.pair_supports.launches == before + 1
    assert torch.equal(got, PS.pair_supports_plain(pt, items, NI, n_words=W))


# (P, NI, n_live, S, W) on each of the kernel's tiles: wide (P and n_live
# >= 128), narrow (P or n_live <= 32; SPAM's wave, the stream's sweep) and
# mid, at W = 1 and W > 1, 16-byte and 4-byte staging, ragged hints
@pytest.mark.parametrize("P,NI,live,S,W", [
    (256, 384, 360, 4096, 1), (130, 130, 129, 517, 2), (200, 150, 131, 1001, 3),
    (12, 64, 17, 99_968, 1), (2048, 128, 17, 4096, 1), (12, 64, 17, 1001, 3),
    (40, 64, 33, 4099, 1), (64, 64, 37, 2053, 2), (12, 64, 37, 40, 40),
    (5, 70, 66, 7, 200)])
def test_kernel_equals_plain_with_live_rows(card, P, NI, live, S, W):
    rng = np.random.default_rng(P * 31 + live)
    pt = _words(rng, P, S * W).to(card)
    items = _words(rng, NI + 3, S * W).to(card)
    items[live:NI] = 0
    want = PS.pair_supports_plain(pt, items, NI, n_words=W, n_live=live)
    before = PS.pair_supports.launches
    for hint in (live, None):
        got = PS.pair_supports(pt, items, NI, n_words=W, n_live=hint)
        torch.cuda.synchronize()
        assert torch.equal(got, want), hint
    assert PS.pair_supports.launches == before + 2


def test_no_live_row_launches_nothing(card):
    pt = _words(np.random.default_rng(1), 40, 512).to(card)
    before = PS.pair_supports.launches
    got = PS.pair_supports(pt, pt, 40, n_live=0)
    assert PS.pair_supports.launches == before
    assert tuple(got.shape) == (40, 40) and not got.any()
    PS.pair_supports(pt, pt, 40, n_live=1)
    assert PS.pair_supports.launches == before + 1


@pytest.mark.parametrize("kw,minsup_rel,cap", [
    (dict(seed=7, n_sequences=400, n_items=40, mean_itemsets=4.0,
          mean_itemset_size=1.4), 0.02, None),
    (dict(seed=8, n_sequences=120, n_items=12, mean_itemsets=40.0,
          max_itemsets=80), 0.5, 3),
])
def test_engine_on_card_matches_oracle(card, kw, minsup_rel, cap):
    db = synthetic_db(**kw)
    minsup = abs_minsup(minsup_rel, len(db))
    before = PS.pair_supports.launches
    got = mine_spade_torch(db, minsup, device=card, max_pattern_itemsets=cap,
                           fused="never", pool_bytes=1 << 20, node_batch=16)
    assert PS.pair_supports.launches > before
    want = mine_spade(db, minsup, max_pattern_itemsets=cap)
    assert patterns_text(got) == patterns_text(want), diff_patterns(want, got)


_SYN21 = dict(seed=21, n_sequences=300, n_items=60, mean_itemsets=6.0,
              mean_itemset_size=1.3)


@pytest.mark.parametrize("kw,minsup_rel,cap", [
    (_SYN21, 0.02, None),
    (dict(seed=8, n_sequences=120, n_items=12, mean_itemsets=40.0,
          max_itemsets=80), 0.5, 3),
])
@pytest.mark.parametrize("fused,key", [("queue", "waves"), ("dense", "levels")])
def test_whole_mine_engines_on_card_match_oracle(card, kw, minsup_rel, cap,
                                                 fused, key):
    db = synthetic_db(**kw)
    minsup = abs_minsup(minsup_rel, len(db))
    before = PS.pair_supports.launches
    stats = {}
    got = mine_spade_torch(db, minsup, device=card, max_pattern_itemsets=cap,
                           fused=fused, stats_out=stats)
    assert stats["fused"] == ("queue" if fused == "queue" else True)
    assert PS.pair_supports.launches - before == stats[key] > 0
    want = mine_spade(db, minsup, max_pattern_itemsets=cap)
    assert patterns_text(got) == patterns_text(want), diff_patterns(want, got)


def test_queue_wave_and_dense_level_make_no_host_sync(card):
    vdb = build_vertical(synthetic_db(**_SYN21), min_item_support=6)
    q = QueueSpadeTorch(vdb, 6, device=card,
                        caps=QueueCaps(nb=32, ring=512, c_cap=2048,
                                       r_cap=16384))
    carry = q.start(q.roots())
    d = FusedSpadeTorch(vdb, 6, device=card,
                        caps=FusedCaps(f_cap=256, c_cap=2048, r_cap=16384))
    d.start(q.roots())
    PS._kernel()   # build and load before the check
    torch.cuda.synchronize()
    before = PS.pair_supports.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        q.wave(carry, q.caps.nb)
        q.wave(carry, q.nb_late)
        d.level()
        d.level()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert PS.pair_supports.launches == before + 4
    head, tail, oflow, wave = carry.ctr.tolist()[:4]
    assert wave == 2 and not oflow and tail > head
    assert d.ctr.tolist()[2] == 2


def _xy(rng, C, km, rows, empty_side=None):
    xy = np.full((C, 2, km), -1, np.int32)
    for c in range(C):
        for side in (0, 1):
            if side != empty_side:
                n = rng.integers(1, km + 1)
                xy[c, side, :n] = rng.choice(rows, n, replace=False)
    return torch.from_numpy(xy)


@pytest.mark.parametrize("C,km,S,W,empty_side", [
    (1, 1, 1, 1, None), (64, 1, 2048, 1, None), (77, 2, 1001, 1, None),
    (130, 4, 4099, 2, None), (257, 8, 517, 3, None), (65, 2, 33, 40, None),
    (100, 3, 300, 1, None), (70, 2, 2500, 1, 0), (70, 4, 900, 2, 1),
])
def test_rule_kernel_equals_plain(card, C, km, S, W, empty_side):
    rng = np.random.default_rng(C * 31 + S)
    rows = 9
    p1 = _words(rng, rows + 1, S * W).to(card)
    s1 = _words(rng, rows + 1, S * W).to(card)
    p1[rows] = -1
    s1[rows] = -1
    xy = _xy(rng, C, km, rows, empty_side).to(card)
    before = RS.rule_supports.launches
    got = RS.rule_supports(p1, s1, xy, n_words=W)
    torch.cuda.synchronize()
    assert RS.rule_supports.launches == before + 1
    assert torch.equal(got, RS.rule_supports_plain(p1, s1, xy, n_words=W))


def _xy_runs(rng, C, km, M):
    """Candidates in runs that share one side, as TSR's expansions of one
    rule do (the staged kernel reuses the side a run shares), with -1 and
    the pad row M in unused slots and some sides all unused."""
    xy = np.full((C, 2, km), -1, np.int32)

    def side():
        n = rng.integers(0, km + 1)
        out = np.full(km, -1, np.int32)
        out[:n] = rng.choice(M, n, replace=False)
        out[rng.random(km) < 0.05] = M           # the pad row itself
        return out

    c = 0
    while c < C:
        n = min(C - c, int(rng.integers(1, 80)))
        keep = rng.integers(0, 2)
        fixed = side()
        for r in range(c, c + n):
            xy[r, keep] = fixed
            xy[r, 1 - keep] = side()
        c += n
    return torch.from_numpy(xy)


def _rule_case(card, seed, C, km, M, S, W):
    rng = np.random.default_rng(seed)
    p1 = _words(rng, M + 1, S * W).to(card)
    s1 = _words(rng, M + 1, S * W).to(card)
    p1[M] = -1
    s1[M] = -1
    xy = _xy_runs(rng, C, km, M).to(card)
    before = RS.rule_supports.launches
    got = RS.rule_supports(p1, s1, xy, n_words=W)
    torch.cuda.synchronize()
    assert RS.rule_supports.launches == before + 1
    assert torch.equal(got, RS.rule_supports_plain(p1, s1, xy, n_words=W))


@pytest.mark.parametrize("km", RB.KM_LADDER)
@pytest.mark.parametrize("W,C,S", [(1, 4099, 1001), (1, 2050, 1004),
                                   (1, 8200, 70),
                                   (2, 700, 517), (3, 130, 333)])
def test_rule_kernel_runs_of_shared_sides_equal_plain(card, km, W, C, S):
    # ragged C past one staged slice (4096 candidates at km = 1), ragged S
    _rule_case(card, 17 * km + C + W, C, km, 40, S, W)


@pytest.mark.parametrize("km", RB.KM_LADDER)
@pytest.mark.parametrize("extra", [0, 1])
def test_rule_kernel_at_and_past_the_staged_limit(card, km, extra):
    # M at the staged path's limit, and one past it (the walk path)
    M = RS.staged_max_rows(km) + extra
    assert M > 256
    _rule_case(card, km + extra, 300, km, M, 161, 1)


@pytest.mark.parametrize("kw,k,minconf,side,cap", [
    (dict(seed=21, n_sequences=3000, n_items=60, mean_itemsets=5.0), 20, 0.5,
     2, 256),
    (dict(seed=21, n_sequences=3000, n_items=60, mean_itemsets=5.0), 20, 0.5,
     2, 4),                                     # several deepening rounds
    (dict(seed=8, n_sequences=120, n_items=12, mean_itemsets=40.0,
          max_itemsets=80), 10, 0.3, 3, 256),
])
def test_tsr_on_card_matches_cpu_engine(card, kw, k, minconf, side, cap):
    db = synthetic_db(**kw)
    before = RS.rule_supports.launches
    stats = {}
    got = mine_tsr_torch(db, k, minconf, max_side=side, device=card,
                         item_cap=cap, stats_out=stats)
    assert RS.rule_supports.launches > before
    assert (stats["deepening_rounds"] > 1) == (cap < 60)
    assert rules_text(got) == rules_text(mine_tsr_cpu(db, k, minconf,
                                                      max_side=side))


def _deep_db(n_seq=50, run=10, extra=6, seed=7):
    """Every sequence holds the ordered run 0..run-1 plus noise items, so
    deep rules stay live: the resident round defers and hands off."""
    rng = np.random.default_rng(seed)
    return [[[int(it)] for it in list(range(run)) + rng.integers(
        run, run + extra, size=3).tolist()] for _ in range(n_seq)]


def test_resident_waves_make_no_host_sync(card):
    db = synthetic_db(seed=21, n_sequences=3000, n_items=60,
                      mean_itemsets=5.0)
    eng = TsrTorch(build_vertical(db, min_item_support=1), 20, 0.5,
                   max_side=None, device=card)
    m = 60
    caps = RF.ResidentCaps(nb=64, ring=1024, r_cap=2048, d_cap=256)
    p1, s1 = eng._prep(m)
    sup_l = eng._sup_sorted[:m].astype(np.int64).tolist()
    carry = RF.carry_from_state(
        RF.pack_state(RF.root_entries(sup_l, 1, 1, 2, None), [], caps), 1,
        card)
    sup_t = torch.tensor(sup_l, dtype=torch.int32, device=card)
    RS._kernel()   # build and load before the check
    torch.cuda.synchronize()
    before = RS.rule_supports.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        for nb in (caps.nb, caps.nb_late):
            RF.wave(carry, p1, s1, sup_t, 1, 2, 20, 1 << 30, nb, 1,
                    RS.rule_supports)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert RS.rule_supports.launches == before + 2
    rec_count, oflow, waves, head, tail = carry.ctr.tolist()[:5]
    assert waves == 2 and not oflow and rec_count > 0 and tail > head


@pytest.mark.parametrize("case", ["synthetic", "deep_handoff"])
def test_resident_route_on_card_launches_b2_and_equals_cpu(card, case):
    if case == "synthetic":
        db, k, minconf = synthetic_db(seed=21, n_sequences=3000, n_items=60,
                                      mean_itemsets=5.0), 20, 0.5
    else:
        db, k, minconf = _deep_db(), 300, 0.3
    before = RS.rule_supports.launches
    got_s, want_s = {}, {}
    got = mine_tsr_torch(db, k, minconf, max_side=None, resident="always",
                         device=card, stats_out=got_s)
    launches = RS.rule_supports.launches - before
    want = mine_tsr_torch(db, k, minconf, max_side=None, resident="always",
                          device="cpu", stats_out=want_s)
    assert rules_text(got) == rules_text(want)
    assert rules_text(got) == rules_text(mine_tsr_cpu(db, k, minconf,
                                                      max_side=None))
    # the resident route is the same program on both devices; a handoff's
    # host loop plans its launches per device (kernel or plain widths)
    assert resident_counters(got_s) == resident_counters(want_s)
    if case == "synthetic":
        got_s.pop("wait_s")
        want_s.pop("wait_s")
        assert got_s == want_s
    assert got_s["resident"] is True and got_s["resident_waves"] > 0
    # B2 once a wave; a handoff's host loop launches it too
    host_launches = sum(v for key, v in got_s.items()
                        if key.startswith("launches_km"))
    assert launches == got_s["resident_waves"] + host_launches
    assert (host_launches > 0) == (case == "deep_handoff")


@pytest.mark.parametrize("kw,minsup_rel,gap,win,cap", [
    (dict(seed=30, n_sequences=3000, n_items=40, mean_itemsets=5.0,
          mean_itemset_size=1.3), 0.03, 2, 5, None),
    (dict(seed=31, n_sequences=1500, n_items=20, mean_itemsets=5.0),
     0.05, None, 4, None),
    (dict(seed=33, n_sequences=60, n_items=10, mean_itemsets=100.0,
          max_itemsets=150), 0.5, 1, 3, 3),            # int16 states
])
def test_cspade_on_card_equals_cpu(card, kw, minsup_rel, gap, win, cap):
    db = synthetic_db(**kw)
    minsup = abs_minsup(minsup_rel, len(db))
    got_s, want_s = {}, {}
    got = mine_cspade_torch(db, minsup, maxgap=gap, maxwindow=win,
                            max_pattern_itemsets=cap, device=card,
                            pool_bytes=1 << 26, stats_out=got_s)
    want = mine_cspade_torch(db, minsup, maxgap=gap, maxwindow=win,
                             max_pattern_itemsets=cap, device="cpu",
                             pool_bytes=1 << 26, stats_out=want_s)
    assert patterns_text(got) == patterns_text(want), diff_patterns(want, got)
    assert got_s == want_s and got_s["patterns"] > 0


def _max_starts(rng, nb, S, n_pos, dtype):
    """States that start 0..8 positions back where a pattern ends (one
    position in 4), else -1; int8 values stay at or under 127."""
    pos = np.arange(n_pos)
    starts = np.minimum(np.maximum(pos - rng.integers(0, 9, (nb, S, n_pos)),
                                   0), 127 if dtype == torch.int8 else n_pos)
    return torch.from_numpy(np.where(rng.random((nb, S, n_pos)) < 0.25,
                                     starts, -1)).to(dtype)


@pytest.mark.parametrize("W,S", [(1, 1), (1, 1001), (3, 517), (9, 59_601)])
@pytest.mark.parametrize("dtype", [torch.int8, torch.int16])
def test_window_mask_kernel_equals_plain(card, dtype, W, S):
    rng = np.random.default_rng(W * 7 + S)
    nb = 2 if S > 10_000 else 5
    m = _max_starts(rng, nb, S, 32 * W, dtype).to(card)
    pm = MT.prev_max(m, 2)
    for win in (None, 0, 3, 5, 32 * W + 4):
        want = MM.window_masks_plain(m, pm, win, W)
        before = MM.window_masks.launches
        got = MM.window_masks(m, pm, win, W)
        torch.cuda.synchronize()
        assert MM.window_masks.launches == before + 1
        assert torch.equal(got, want), win
    # states whose data is not 16-byte aligned are refused, not launched
    flat = torch.empty(m.numel() + 1, dtype=dtype, device=card)
    m_off = flat[1:].view(m.shape)
    assert m_off.data_ptr() % 16 != 0
    before = MM.window_masks.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        MM.window_masks(m_off, pm, 5, W)
    assert MM.window_masks.launches == before


def test_cspade_supports_launch_masks_and_b1_once_a_batch(card):
    """Every batch with candidates launches the mask kernel once and B1
    once, and the ``cspade.supports`` span says so."""
    from spark_fsm_tpu_torch.utils import obs

    db = synthetic_db(seed=30, n_sequences=3000, n_items=40,
                      mean_itemsets=5.0, mean_itemset_size=1.3)
    minsup = abs_minsup(0.03, len(db))
    was = obs.tracing_enabled()
    obs.configure_tracing(True, max_spans=1 << 15, max_jobs=8)
    try:
        masks0, b1_0 = MM.window_masks.launches, PS.pair_supports.launches
        stats: dict = {}
        got = mine_cspade_torch(db, minsup, maxgap=2, maxwindow=5,
                                device=card, pool_bytes=1 << 26,
                                stats_out=stats)
        torch.cuda.synchronize()
        spans = obs.trace_dump(obs.last_trace_id())["spans"]
    finally:
        obs.configure_tracing(was)
    sup = [s["attrs"] for s in spans if s["site"] == "cspade.supports"]
    assert len(sup) > 1 and all(a["masks"] == a["b1"] == 1 for a in sup)
    assert MM.window_masks.launches - masks0 == len(sup)
    assert PS.pair_supports.launches - b1_0 == len(sup)
    assert sum(a["launches"] for a in sup) == sum(
        -(-a["candidates"] // stats["geometry"]["chunk"]) for a in sup)
    assert patterns_text(got) == patterns_text(mine_cspade_torch(
        db, minsup, maxgap=2, maxwindow=5, device="cpu", pool_bytes=1 << 26))


@pytest.mark.parametrize("P,NI,n_items,S,W", [
    (1, 32, 1, 1, 1), (12, 64, 17, 1001, 1), (14, 64, 26, 517, 2),
    (37, 128, 100, 4099, 3), (128, 64, 26, 2500, 1), (33, 96, 90, 70, 40),
])
def test_extend_kernel_equals_plain(card, P, NI, n_items, S, W):
    rng = np.random.default_rng(P * 131 + S)
    pt = _words(rng, P, S * W).to(card)
    items = _words(rng, NI + 5, S * W).to(card)
    items[n_items:NI] = 0                      # all-zero pad rows
    counts = PS.pair_supports_plain(pt, items, NI, n_words=W)
    for thr in (1, max(1, int(counts[:, :n_items].float().median())),
                int(counts.max()) + 1):
        before = EP.extend_count_prune.launches
        sup, mask = EP.extend_count_prune(pt, items, thr, NI, n_words=W)
        torch.cuda.synchronize()
        assert EP.extend_count_prune.launches == before + 1
        want = EP.extend_count_prune_plain(
            pt.view(P, S, W), items[:NI].view(NI, S, W), thr,
            torch.zeros(P, dtype=torch.bool))
        assert torch.equal(sup, want[0]) and torch.equal(mask, want[1])
        if thr == 1:
            assert torch.equal(sup, counts)     # B3 at thr 1 is B1


@pytest.mark.parametrize("kw,minsup_rel,extra", [
    (dict(seed=3, n_sequences=400, n_items=12, mean_itemsets=4.0,
          mean_itemset_size=1.4), 0.05, {}),
    (dict(seed=401, n_sequences=300, n_items=24, mean_itemsets=4.0,
          mean_itemset_size=1.3, zipf_s=2.2), 0.05,
     {"density_crossover": 0.3}),                 # hybrid plan
    (dict(seed=8, n_sequences=120, n_items=12, mean_itemsets=40.0,
          max_itemsets=80), 0.5, {"max_pattern_itemsets": 3}),
])
def test_spam_on_card_matches_oracle(card, kw, minsup_rel, extra):
    db = synthetic_db(**kw)
    minsup = abs_minsup(minsup_rel, len(db))
    before = EP.extend_count_prune.launches
    stats = {}
    got = mine_spam_torch(db, minsup, device=card, pool_bytes=1 << 24,
                          node_batch=8, stats_out=stats, **extra)
    assert EP.extend_count_prune.launches - before == stats["waves"] > 0
    if "density_crossover" in extra:
        assert stats["rep_idlist"] > 0 and stats["pair_launches"] > 0
    want = mine_spade(db, minsup,
                      max_pattern_itemsets=extra.get("max_pattern_itemsets"))
    assert patterns_text(got) == patterns_text(want), diff_patterns(want, got)


@pytest.mark.parametrize("S", [3001, 3004])     # one word / four a load
@pytest.mark.parametrize("n_live", [1, 17, 31, 32, 33, 64])
@pytest.mark.parametrize("P", [1, 12, 16, 17, 33, 128])
def test_extend_kernel_live_hint_equals_plain(card, P, n_live, S):
    NI = 64
    W = 2 if P == 17 else 1                     # the W > 1 path takes it too
    rng = np.random.default_rng(P * 1009 + n_live + S)
    pt = _words(rng, P, S * W).to(card)
    items = _words(rng, NI + 2, S * W).to(card)
    items[n_live:NI] = 0                        # the hint's contract
    counts = PS.pair_supports_plain(pt, items, NI, n_words=W)
    for thr in (1, max(1, int(counts[:, :n_live].float().median())),
                int(counts.max()) + 1):
        want = EP.extend_count_prune_plain(
            pt.view(P, S, W), items[:NI].view(NI, S, W), thr,
            torch.zeros(P, dtype=torch.bool))
        for hint in (n_live, None):
            before = EP.extend_count_prune.launches
            sup, mask = EP.extend_count_prune(pt, items, thr, NI, n_words=W,
                                              n_live=hint)
            torch.cuda.synchronize()
            assert EP.extend_count_prune.launches == before + 1
            assert torch.equal(sup, want[0]) and torch.equal(mask, want[1])


# ------------------------------------------------------- streaming windows


def _stream(seed, n_batches, per_batch, **kw):
    rng = np.random.default_rng(seed)
    return [synthetic_db(seed=int(rng.integers(1 << 30)),
                         n_sequences=per_batch, **kw)
            for _ in range(n_batches)]


@pytest.mark.parametrize("min_support,kw", [
    (0.2, dict(n_items=12, mean_itemsets=3.0)),
    # > 32 itemsets a sequence: 2-word stores; patterns cross the border
    (0.85, dict(n_items=6, mean_itemsets=40.0, mean_itemset_size=1.1)),
])
def test_incremental_miner_on_card_equals_cpu(card, min_support, kw):
    """Every push on the card (B1 a level) equals the same stream on the
    CPU (B1's plain version: the same stats), the oracle and the re-mine
    miner on the card."""
    from spark_fsm_tpu_torch.streaming import (
        IncrementalWindowMiner, WindowMiner)

    gpu = IncrementalWindowMiner(min_support, max_batches=2, device=card)
    # the same branch on the CPU: B1's plain version
    cpu = IncrementalWindowMiner(min_support, max_batches=2, device="cpu",
                                 use_kernel=True)
    rem = WindowMiner(min_support, max_batches=2, device=card)
    assert gpu.use_kernel
    swept = 0
    for batch in _stream(8, 4, 40, **kw):
        # the sweep walks a level (one B1 launch) per tracked parent level
        levels = any(n.children for n in gpu._root.values())
        before = PS.pair_supports.launches
        got = gpu.push(batch)
        assert (PS.pair_supports.launches > before) == levels
        swept += levels
        assert patterns_text(got) == patterns_text(cpu.push(batch))
        assert patterns_text(got) == patterns_text(rem.push(batch))
        want = mine_spade(gpu.window.sequences(), gpu.minsup_abs())
        assert patterns_text(got) == patterns_text(want)
        skip = ("phase_s", "push_wall_s")
        assert ({k: v for k, v in gpu.stats.items() if k not in skip}
                == {k: v for k, v in cpu.stats.items() if k not in skip})
    assert gpu.stats["repaired_nodes"] > 0 and swept >= 2


def test_sweep_dispatch_makes_no_host_sync(card):
    """The sweep's dispatch (store build, every level's prep, B1 and
    materialize, each supports copy started) runs under sync-debug
    "error"; its resolve then waits once."""
    from spark_fsm_tpu_torch.streaming import IncrementalWindowMiner

    batches = _stream(3, 2, 200, n_items=12, mean_itemsets=4.0)
    miner = IncrementalWindowMiner(0.1, max_batches=2, device=card)
    miner.push(batches[0])              # grows the tree to sweep
    ref = IncrementalWindowMiner(0.1, max_batches=2, device="cpu")
    ref.push(batches[0])
    ref.push(batches[1])
    from spark_fsm_tpu_torch.streaming.incremental import _BatchTokens
    st = _BatchTokens(7, batches[1], card)   # the next batch, by hand
    f1 = sorted(g for g, _ in miner._root)
    PS._kernel()
    torch.cuda.synchronize()
    before = PS.pair_supports.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        pend, event = miner._sweep_dispatch(st, f1)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert event is not None and pend
    assert PS.pair_supports.launches > before
    miner._resolve(st.bid, pend, event)
    # each tracked node got this batch's exact support
    by_steps = {}
    stack = list(ref._root.values())
    while stack:
        n = stack.pop()
        by_steps[n.steps] = n
        stack.extend(n.children.values())
    stack = list(miner._root.values())
    checked = 0
    while stack:
        n = stack.pop()
        stack.extend(n.children.values())
        r = by_steps.get(n.steps)
        if r is not None and 1 in r.sup:
            assert n.sup[7] == r.sup[1], n.steps
            checked += 1
    assert checked > 10


def _predict_fixture(seed, n_rules=300, n_items=40, n_prefixes=40):
    """A random rule set with planted (conf, sup) ties and seeded
    prefixes, as ``tests/test_torch_rule_trie.random_rules`` draws them."""
    import random

    rng = random.Random(seed)
    rules = []
    for _ in range(n_rules):
        x = tuple(sorted(rng.sample(range(n_items), rng.randint(0, 3))))
        rest = [i for i in range(n_items) if i not in x]
        y = tuple(sorted(rng.sample(rest, rng.randint(1, 2))))
        supx = rng.randint(1, 12)
        rules.append((x, y, rng.randint(1, supx), supx))
    rules[1] = (rules[0][0], (n_items + 1,), rules[0][2], rules[0][3])
    prefixes = [sorted(rng.sample(range(n_items + 2), rng.randint(0, 12)))
                for _ in range(n_prefixes)]
    return rules, prefixes


@pytest.mark.parametrize("m", [1, 8, 2000])
@pytest.mark.parametrize("W", [1, 16, 64])
def test_scorer_on_card_equals_cpu(card, W, m):
    """``score_wave`` on a trie on the card equals the same trie on the
    CPU and ``predict_host``, row for row, as JSON; the planes and
    ``nbytes`` are the CPU build's."""
    import json

    from spark_fsm_tpu_torch.ops import rule_trie as RT

    rules, prefixes = _predict_fixture(W + m)
    gpu = RT.build_trie(rules, lanes_floor=1024, depth_floor=16, device=card)
    cpu = RT.build_trie(rules, lanes_floor=1024, depth_floor=16, device="cpu")
    assert gpu.ante_tok.device == card and gpu.nbytes() == cpu.nbytes()
    for f in RT.PLANES:
        assert torch.equal(getattr(gpu, f).cpu(), getattr(cpu, f)), f
    for i in range(0, len(prefixes), W):
        wave = prefixes[i:i + W]
        got = RT.score_wave(gpu, wave, m)
        assert got == RT.score_wave(cpu, wave, m)
        for p, row in zip(wave, got):
            assert (json.dumps(row, sort_keys=True)
                    == json.dumps(RT.predict_host(rules, p, m), sort_keys=True))


def test_scorer_body_makes_no_host_sync(card):
    """The wave up to its one readback — the pinned upload of the prefix
    rows, the scorer and the start of the three copies back — runs under
    sync-debug "error"; one event wait then lands the rows."""
    from spark_fsm_tpu_torch.models._common import to_device, to_host
    from spark_fsm_tpu_torch.ops import rule_trie as RT

    rules, prefixes = _predict_fixture(5)
    trie = RT.build_trie(rules, lanes_floor=1024, depth_floor=16, device=card)
    q = RT.pack_wave(trie, prefixes[:16])
    RT.score_wave(trie, prefixes[:1], 8)      # warm the allocators
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = RT.score_device(trie, to_device(q, card), 8)
        host, event = to_host(outs)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert event is not None and all(t.device == card for t in outs)
    event.synchronize()
    got = RT.decode_wave(trie, 16, 8, 8, *(h.numpy() for h in host))
    assert got == [RT.predict_host(rules, p, 8) for p in prefixes[:16]]


def test_broker_threads_keep_the_trie_device(card, monkeypatch):
    """Sixteen threads submit through the broker with its window on: every
    wave's tensors sit on the trie's card (whatever a thread's current
    device), at least one wave fuses, and every row equals the CPU's."""
    import threading

    from spark_fsm_tpu_torch.ops import rule_trie as RT
    from spark_fsm_tpu_torch.service import predictor as PR

    rules, prefixes = _predict_fixture(9, n_prefixes=64)
    trie = RT.build_trie(rules, lanes_floor=1024, depth_floor=16, device=card)
    cpu = RT.build_trie(rules, lanes_floor=1024, depth_floor=16, device="cpu")
    devices = set()
    score = RT.score_device

    def spy(t, q, M):
        outs = score(t, q, M)
        devices.update(o.device for o in (q,) + outs)
        return outs

    monkeypatch.setattr(RT, "score_device", spy)
    monkeypatch.setitem(PR._cfg, "window_ms", 20.0)
    monkeypatch.setitem(PR._cfg, "max_wave", 8)
    broker = PR.PredictBroker()
    tickets = [None] * len(prefixes)

    def go(k):
        for i in range(k, len(prefixes), 16):
            tickets[i] = broker.submit(trie, prefixes[i], 8, "normal",
                                       tag=str(i))

    threads = [threading.Thread(target=go, args=(k,)) for k in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    broker.shutdown()
    assert devices == {card}
    assert max(t.wave_jobs for t in tickets) >= 2
    for p, t in zip(prefixes, tickets):
        assert t.entries == RT.score_wave(cpu, [p], 8)[0]


# ---------------------------------------------------------------- meshes


def _one_device_mines(card):
    import _torch_mesh_worker as W
    return {name: W.card_mine(name, device=card) for name in W.CARD_MINES}


@pytest.mark.parametrize("backend,ranks", [("nccl", 1), ("gloo", 2)])
def test_mesh_mines_on_card_equal_one_device(card, backend, ranks):
    import _torch_mesh_worker as W
    from spark_fsm_tpu_torch.parallel.launch import spawn_world

    PS._kernel(), RS._kernel(), EP._kernel()   # built once, before the ranks
    want = _one_device_mines(card)
    got = spawn_world(W.card_mines, ranks, backend, "cuda:0", timeout_s=600)
    for rank in got:
        for name, (text, fused, resident, launches) in rank.items():
            assert text == want[name][0], (backend, name)
            assert fused == want[name][1].get("fused"), name
            b1, b2, b3 = launches
            if name == "tsr":
                assert b2 > 0 and not resident and b1 == b3 == 0
            else:
                assert b1 > 0 and b2 == b3 == 0, (name, launches)


def test_mesh_queue_waves_make_no_host_sync(card):
    import _torch_mesh_worker as W
    from spark_fsm_tpu_torch.parallel.launch import spawn_world

    PS._kernel()
    assert spawn_world(W.queue_waves_sync_free, 1, "nccl", "cuda:0",
                       timeout_s=300) == [2]


# ------------------------------------------------------- class partitions


@pytest.mark.parametrize("name", ["spade_queue", "spade_classic", "spam",
                                  "tsr", "tsr_resident", "cspade"])
def test_partitioned_mines_on_card_equal_one_device(card, name):
    """Two class partitions mined in turn on the card launch the route's
    kernel and give the one-device text."""
    db = synthetic_db(seed=21, n_sequences=300, n_items=60, mean_itemsets=6.0,
                      mean_itemset_size=1.3)
    minsup = abs_minsup(0.02, len(db))
    kernels = {"spade_queue": PS.pair_supports,
               "spade_classic": PS.pair_supports,
               "spam": EP.extend_count_prune, "tsr": RS.rule_supports,
               "tsr_resident": RS.rule_supports}

    def mine(**kw):
        stats: dict = {}
        if name.startswith("spade"):
            fused = "queue" if name == "spade_queue" else "never"
            text = patterns_text(mine_spade_torch(db, minsup, fused=fused,
                                                  stats_out=stats, **kw))
        elif name == "spam":
            text = patterns_text(mine_spam_torch(db, minsup, stats_out=stats,
                                                 **kw))
        elif name == "cspade":
            text = patterns_text(mine_cspade_torch(
                db, minsup, maxgap=2, maxwindow=4, stats_out=stats, **kw))
        else:
            side = None if name == "tsr_resident" else 2
            resident = "always" if name == "tsr_resident" else "auto"
            text = rules_text(mine_tsr_torch(db, 20, 0.5, max_side=side,
                                             resident=resident,
                                             stats_out=stats, **kw))
        return text, stats

    want, _ = mine(device=card)
    kernel = kernels.get(name)
    before = kernel.launches if kernel is not None else 0
    got, stats = mine(device=card, partition_parts=2)
    torch.cuda.synchronize()
    assert got == want
    assert stats["partition_parts"] == 2 and stats["partition_exchanges"] >= 1
    if kernel is not None:
        assert kernel.launches > before, name
    if name == "tsr_resident":
        assert stats["resident_waves"] > 0


# ------------------------------------------------------ the warm path


def _tsr_prep(card, seed, n=3000):
    db = synthetic_db(seed=seed, n_sequences=n, n_items=40,
                      mean_itemsets=4.0)
    eng = TsrTorch(build_vertical(db, min_item_support=1), 20, 0.5,
                   device=card)
    m = min(eng.item_cap, eng.vdb.n_items)
    eng.chunk = eng._round_chunk(m)
    return eng, eng._prep(m), m


@pytest.mark.parametrize("km", [1, 2, 4])
def test_fused_store_b2_equals_plain(card, km):
    """B2 on a fused store (two jobs' rows, zero rows, the all-ones row)
    equals its plain version on the same store, candidates spanning both
    jobs' rows with -1 slots."""
    from spark_fsm_tpu_torch.service import fusion

    (_, (pa, sa), ma), (_, (pb, sb), mb) = (_tsr_prep(card, 3),
                                           _tsr_prep(card, 4))
    m_pad = RB.next_pow2(ma + mb)
    pf, sf = fusion._fuse_preps([(pa, sa), (pb, sb)], m_pad, ma + mb)
    assert pf.shape[0] == m_pad + 1 and bool((pf[-1] == -1).all())
    assert bool((pf[ma + mb:m_pad] == 0).all())
    rng = np.random.default_rng(km)
    xy = rng.integers(0, ma + mb, size=(4096, 2, km)).astype(np.int32)
    xy[rng.random(xy.shape) < 0.3] = -1
    xy[:, :, 0] = np.abs(xy[:, :, 0])
    xy_t = torch.from_numpy(xy).to(card)
    got = RS.rule_supports(pf, sf, xy_t)
    want = RS.rule_supports_plain(pf, sf, xy_t)
    assert torch.equal(got, want)


def test_fused_tsr_jobs_on_card_equal_solo(card):
    import threading

    from spark_fsm_tpu_torch import config as TC
    from spark_fsm_tpu_torch.service import fusion
    from spark_fsm_tpu_torch.utils import jobctl

    dbs = [synthetic_db(seed=s, n_sequences=2000, n_items=30,
                        mean_itemsets=4.0) for s in (5, 6)]
    want = [rules_text(mine_tsr_torch(db, 30, 0.5, max_side=2,
                                      device=card)) for db in dbs]
    fusion.configure(TC.FusionConfig(enabled=True, window_ms=100.0))
    b = fusion.broker()
    try:
        b.hold()
        out = {}

        def run(i):
            uid = f"card-fuse-{i}"
            with jobctl.activate(jobctl.register(uid)):
                out[i] = rules_text(mine_tsr_torch(
                    dbs[i], 30, 0.5, max_side=2, device=card))
            jobctl.release(uid)

        ts = [threading.Thread(target=run, args=(i,)) for i in (0, 1)]
        for t in ts:
            t.start()
        while b.pending() < 2:
            pass
        launches0 = RS.rule_supports.launches
        b.release()
        for t in ts:
            t.join(120)
        assert [out[0], out[1]] == want
        assert b.stats["cross_job_launches"] >= 1
        assert RS.rule_supports.launches > launches0
    finally:
        b.release()
        fusion.configure(None)


def test_prewarmed_first_mine_builds_and_loads_nothing(card):
    """After a prewarm at the envelope, a first TSR and SPADE mine record
    only enumerated keys and build or load no kernel library.  The
    libraries load once a process, so this holds only where the prewarm
    paid the loads, in a fresh process (the test runs one)."""
    import subprocess
    import sys

    code = r"""
import torch
from spark_fsm_tpu_torch.data.synth import synthetic_db
from spark_fsm_tpu_torch.data.vertical import build_vertical
from spark_fsm_tpu_torch.models.spade import mine_spade_torch
from spark_fsm_tpu_torch.models.tsr import mine_tsr_torch
from spark_fsm_tpu_torch.service import prewarm
from spark_fsm_tpu_torch.utils import shapes
from spark_fsm_tpu_torch.utils.jitcache import compile_counts
db = synthetic_db(seed=9, n_sequences=3000, n_items=40, mean_itemsets=4.0)
vdb = build_vertical(db, min_item_support=1)  # TSR's projection
report = prewarm.run(shapes.WorkloadSpec(
    n_sequences=len(db), n_items=vdb.n_items, n_words=vdb.n_words,
    tsr=True), device="cuda")
assert not [r for r in report["keys"] if "error" in r], report
assert sum(r["fresh_compiles"] for r in report["keys"]) >= 3, report
c0 = compile_counts()
mine_spade_torch(db, 30, device="cuda")
mine_tsr_torch(db, 20, 0.5, max_side=None, device="cuda")
torch.cuda.synchronize()
assert compile_counts() == c0, (compile_counts(), c0)
assert shapes.drift(report["enumerated"]) == [], shapes.drift(report["enumerated"])
print("OK")
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0 and "OK" in proc.stdout, proc.stderr[-3000:]


def test_oom_drill_on_card_keeps_rules(card):
    from spark_fsm_tpu_torch.utils import faults

    db = synthetic_db(seed=11, n_sequences=3000, n_items=40,
                      mean_itemsets=4.0)
    vdb = build_vertical(db, min_item_support=1)
    want = rules_text(TsrTorch(vdb, 30, 0.5, max_side=2, device=card).mine())
    eng = TsrTorch(vdb, 30, 0.5, max_side=2, device=card)
    with faults.injected("device.oom", nth=1):
        got = rules_text(eng.mine())
    assert got == want
    assert eng.stats["degraded_launches"] >= 1


def test_oom_on_a_fused_launch_on_card_keeps_rules(card):
    """An injected OOM on the broker's first (cross-job) launch halves it
    through the engine's ladder: both jobs' rules equal their solo mines'
    and each job counts the halving."""
    import threading

    from spark_fsm_tpu_torch import config as TC
    from spark_fsm_tpu_torch.service import fusion
    from spark_fsm_tpu_torch.utils import faults, jobctl

    vdbs = [build_vertical(synthetic_db(seed=s, n_sequences=2000, n_items=30,
                                        mean_itemsets=4.0),
                           min_item_support=1) for s in (5, 6)]
    want = [rules_text(TsrTorch(v, 30, 0.5, max_side=2, device=card).mine())
            for v in vdbs]
    engs = [TsrTorch(v, 30, 0.5, max_side=2, device=card) for v in vdbs]
    fusion.configure(TC.FusionConfig(enabled=True, window_ms=100.0))
    b = fusion.broker()
    try:
        b.hold()
        out = {}

        def run(i):
            uid = f"card-oom-{i}"
            with jobctl.activate(jobctl.register(uid)):
                out[i] = rules_text(engs[i].mine())
            jobctl.release(uid)

        with faults.injected("device.oom", nth=1):
            ts = [threading.Thread(target=run, args=(i,)) for i in (0, 1)]
            for t in ts:
                t.start()
            while b.pending() < 2:
                pass
            b.release()
            for t in ts:
                t.join(120)
        assert [out[0], out[1]] == want
        assert b.stats["cross_job_launches"] >= 1
        assert all(e.stats.get("degraded_launches", 0) >= 1 for e in engs)
    finally:
        b.release()
        fusion.configure(None)
