"""The port's warm path (``utils/shapes.py``, ``service/prewarm.py``,
``utils/jitcache.py``) against the reference's, on the CPU.

Mirrors the reference's ``tests/test_shapes.py``:

- the key spellings, and every geometry function's ``shape_key`` equal to
  the reference's over a grid of sizes, with and without
  ``shape_buckets``;
- ``enumerate_shapes`` equal to the reference's, key for key and kind for
  kind, for the same ``WorkloadSpec``;
- every engine's runtime keys equal to the reference's for the same
  mines, and covered by the enumeration (no drift);
- prewarm on the CPU, then first mines and stream pushes that record only
  enumerated keys and build or load nothing (``compile_counts``: the CPU
  never builds a kernel);
- the TSR super-batch, resident, partitioned and predict ladders through
  prewarm;
- ``/admin/prewarm`` and ``/admin/shapes`` bodies against the reference
  service's (wall-clock fields aside)."""

import json
import urllib.parse
import urllib.request

import pytest

from spark_fsm_tpu.data.vertical import build_vertical as j_build_vertical
from spark_fsm_tpu.models import spade_constrained as JC
from spark_fsm_tpu.models import spade_fused as JF
from spark_fsm_tpu.models import spade_queue as JQ
from spark_fsm_tpu.models import spade_tpu as JS
from spark_fsm_tpu.models import spam_bitmap as JB
from spark_fsm_tpu.models import tsr as JT
from spark_fsm_tpu.service import app as JA
from spark_fsm_tpu.streaming import incremental as JI
from spark_fsm_tpu.utils import shapes as JSH
from spark_fsm_tpu_torch.data.synth import synthetic_db
from spark_fsm_tpu_torch.data.vertical import build_vertical
from spark_fsm_tpu_torch.models import spade as TS
from spark_fsm_tpu_torch.models import spade_constrained as TCS
from spark_fsm_tpu_torch.models import spade_fused as TF
from spark_fsm_tpu_torch.models import spade_queue as TQ
from spark_fsm_tpu_torch.models import spam_bitmap as TB
from spark_fsm_tpu_torch.models import tsr as TT
from spark_fsm_tpu_torch.models.oracle import mine_cspade, mine_spade
from spark_fsm_tpu_torch.ops import ragged_batch as RB
from spark_fsm_tpu_torch.ops import resident_frontier as RF
from spark_fsm_tpu_torch.ops import rule_trie
from spark_fsm_tpu_torch.service import app as TA
from spark_fsm_tpu_torch.service import prewarm
from spark_fsm_tpu_torch.streaming import incremental as TI
from spark_fsm_tpu_torch.utils import shapes
from spark_fsm_tpu_torch.utils.canonical import patterns_text
from spark_fsm_tpu_torch.utils.jitcache import (compile_counts,
                                                enable_compile_counter)

BATCH = 50  # streaming micro-batch size used throughout
POOL = 64 << 20  # a pinned pool budget: the port's default reads the card


def _db(seed=77, n=150):
    return synthetic_db(seed=seed, n_sequences=n, n_items=11,
                        mean_itemsets=3.0)


def test_key_formats_are_the_engine_spellings():
    args = {
        "key_classic": (128, 1, 530, 16, 64), "key_queue": (128, 1, 128,
                                                            512, 8192),
        "key_fused": (77500, 1, 384, 1024),
        "key_cspade": (128, 1, 12, 64, 32, 256, None, 5, 16),
        "key_tsr": (990000, 2), "key_tsr_eval": (128, 1, 4, 256),
        "key_tsr_fused": (128, 1, 512, 2, 1024),
        "key_tsr_resident": (9900, 1, 256, 4, 512, 16384),
        "key_spam": (128, 1, 530, 16, 64),
        "key_spam_hybrid": (128, 1, 530, 16, 64, 0),
        "key_spam_pair": (128, 1, 256), "key_predict": (1024, 16, 8, 8),
        "key_sweep": (128, 1, 256, 128), "key_tsr_part": (2, 128, 1),
    }
    for name, a in args.items():
        assert getattr(shapes, name)(*a) == getattr(JSH, name)(*a), name
    assert shapes.key_classic(128, 1, 530, 16, 64) == \
        "classic:s128w1r530nb16c64"
    assert shapes.key_cspade(128, 1, 12, 64, 32, 256, None, None, 16) == \
        "cspade:s128w1i12p64nb32c256gnxnd16"


GRID = [(n, ni, w, pool)
        for n in (150, 1001, 77500, 990000)
        for ni, w in ((11, 1), (300, 2))
        for pool in (1, 64 << 20, 26 << 30)]


@pytest.mark.parametrize("buckets", [False, True])
def test_geometry_shape_keys_equal_reference(buckets):
    """Every geometry function's key equals the reference's XLA-path key
    (``use_pallas=False``) over the grid."""
    for n, ni, w, pool in GRID:
        kw = dict(pool_bytes=pool, shape_buckets=buckets)
        pairs = [
            (TS.classic_geometry(n, ni, w, **kw),
             JS.classic_geometry(n, ni, w, **kw)),
            (TB.spam_geometry(n, ni, w, **kw),
             JB.spam_geometry(n, ni, w, **kw)),
            (TCS.cspade_geometry(n, ni, w, maxgap=2, maxwindow=None, **kw),
             JC.cspade_geometry(n, ni, w, maxgap=2, maxwindow=None, **kw)),
            (TT.tsr_geometry(n, shape_buckets=buckets, n_words=w),
             JT.tsr_geometry(n, w, shape_buckets=buckets)),
        ]
        caps = TQ.QueueCaps.for_budget(n * w * 4, 384, pool)
        jcaps = JQ.QueueCaps.for_budget(n * w * 4, 384, pool)
        pairs.append((TQ.queue_geometry(n, ni, w, shape_buckets=buckets,
                                        caps=caps),
                      JQ.queue_geometry(n, ni, w, shape_buckets=buckets,
                                        caps=jcaps)))
        pairs.append((TF.fused_geometry(n, ni, w, shape_buckets=buckets),
                      JF.fused_geometry(n, ni, w, shape_buckets=buckets)))
        for got, want in pairs:
            assert got["shape_key"] == want["shape_key"], (n, ni, w, pool)
    for n in (50, 99000):
        for floor in (0, 4096):
            assert (TI.sweep_geometry(n, 3, seq_floor=floor)
                    == {k: v for k, v in JI.sweep_geometry(
                        n, 3, seq_floor=floor).items() if k != "s_block"})


SPECS = {
    "batch+stream": dict(n_sequences=150, n_items=11, constraints=((2, 5),),
                         tsr=True, stream_batch_sequences=BATCH,
                         stream_items=11),
    "bms+fusion+parts+predict": dict(
        n_sequences=77500, n_items=300, tsr=True, fusion_jobs=8,
        partition_parts=2, constraints=((None, None),), predict_lanes=64,
        predict_depth=8, predict_wave=4, predict_topm=4),
    "kosarak+words": dict(n_sequences=990000, n_items=4000, n_words=2,
                          tsr=True, fusion_jobs=3, checkpointed=True),
    "stream floor": dict(n_sequences=1000, n_items=33, n_words=3,
                         stream_batch_sequences=300, stream_items=40,
                         stream_seq_floor=1000),
}


@pytest.mark.parametrize("name", sorted(SPECS))
def test_enumerate_shapes_equals_reference(name):
    spec = SPECS[name]
    ekw = {"tsr_chunk": 256} if name == "batch+stream" else None
    want = JSH.enumerate_shapes(JSH.WorkloadSpec(**spec),
                                engine_kwargs=ekw)
    got = shapes.enumerate_shapes(shapes.WorkloadSpec(**spec),
                                  engine_kwargs=ekw, device="cpu")
    assert ({k: t["kind"] for k, t in got.items()}
            == {k: t["kind"] for k, t in want.items()})
    for key, t in want.items():
        for field in ("superbatch", "fused_m", "m", "nb", "km", "ring",
                      "nd_pad", "width", "n_rows", "ni_rows"):
            assert got[key].get(field) == t.get(field), (key, field)


@pytest.fixture(scope="module")
def runtime_keys():
    """The keys one set of service-default mines records in each package:
    SPADE's router (the queue engine), the classic and dense engines,
    cSPADE, SPAM on a hybrid plan, TSR's host loop and resident route, a
    partitioned TSR mine and two stream pushes."""
    db = _db()
    minsup = 6
    spec = dict(n_sequences=len(db),
                n_items=build_vertical(db, min_item_support=minsup).n_items,
                constraints=((2, 5),), tsr=True, partition_parts=2,
                stream_batch_sequences=BATCH,
                stream_items=build_vertical(db[:BATCH],
                                            min_item_support=1).n_items)
    out = {}
    for pkg in ("ref", "port"):
        reg = JSH if pkg == "ref" else shapes
        reg.reset_recorded()
        if pkg == "ref":
            vdb = j_build_vertical(db, min_item_support=minsup)
            engines = [JQ.QueueSpadeTPU(vdb, minsup),
                       JS.SpadeTPU(vdb, minsup, pool_bytes=POOL),
                       JF.FusedSpadeTPU(vdb, minsup),
                       JC.ConstrainedSpadeTPU(vdb, minsup, maxgap=2,
                                              maxwindow=5, pool_bytes=POOL),
                       JB.SpamBitmapTPU(vdb, minsup, pool_bytes=POOL,
                                        density_crossover=0.5)]
            engines[-1].mine()
            JT.mine_tsr_tpu(db, 8, 0.5, max_side=2)
            JT.mine_tsr_tpu(db, 8, 0.5, max_side=None, resident="always")
            JT.mine_tsr_tpu(db, 8, 0.5, max_side=2, partition_parts=2)
            miner = JI.IncrementalWindowMiner(0.1, max_batches=3)
        else:
            vdb = build_vertical(db, min_item_support=minsup)
            engines = [TQ.QueueSpadeTorch(vdb, minsup, device="cpu"),
                       TS.SpadeTorch(vdb, minsup, pool_bytes=POOL,
                                     device="cpu"),
                       TF.FusedSpadeTorch(vdb, minsup, device="cpu"),
                       TCS.ConstrainedSpadeTorch(vdb, minsup, maxgap=2,
                                                 maxwindow=5, pool_bytes=POOL,
                                                 device="cpu"),
                       TB.SpamBitmapTorch(vdb, minsup, pool_bytes=POOL,
                                          density_crossover=0.5,
                                          device="cpu")]
            engines[-1].mine()
            TT.mine_tsr_torch(db, 8, 0.5, max_side=2, device="cpu")
            TT.mine_tsr_torch(db, 8, 0.5, max_side=None, resident="always",
                              device="cpu")
            TT.mine_tsr_torch(db, 8, 0.5, max_side=2, partition_parts=2,
                              device="cpu")
            miner = TI.IncrementalWindowMiner(0.1, max_batches=3,
                                              device="cpu")
        miner.push(db[:BATCH])
        miner.push(db[BATCH:2 * BATCH])
        out[pkg] = (reg.recorded(), [e.stats["shape_key"] for e in engines],
                    {k: miner.stats.get(k)
                     for k in ("shape_key", "sweep_shape_keys")})
    return spec, out


def test_runtime_shape_keys_equal_reference(runtime_keys):
    _, out = runtime_keys
    assert out["port"] == out["ref"]
    assert out["port"][2]["shape_key"].startswith("sweep:")


def test_enumeration_covers_runtime_keys_no_drift(runtime_keys):
    """Every key the mines recorded was enumerated from (sequences, items,
    words) alone; the engines' constructor pool budgets pinned the same."""
    spec, out = runtime_keys
    enumerated = set(shapes.enumerate_shapes(
        shapes.WorkloadSpec(**spec), engine_kwargs={"pool_bytes": POOL},
        device="cpu"))
    enumerated |= set(shapes.enumerate_shapes(
        shapes.WorkloadSpec(**spec), device="cpu"))
    missing = sorted(k for k in out["port"][0] if k not in enumerated)
    assert not missing, missing


@pytest.fixture(scope="module")
def warmed():
    """One prewarm over a batch + constrained + streaming envelope."""
    enable_compile_counter()
    db = _db(seed=78)
    minsup = 6
    vdb = build_vertical(db, min_item_support=minsup)
    spec = shapes.WorkloadSpec(
        n_sequences=len(db), n_items=vdb.n_items, n_words=vdb.n_words,
        constraints=((2, 5),),
        stream_batch_sequences=BATCH,
        stream_items=build_vertical(db[:BATCH],
                                    min_item_support=1).n_items)
    shapes.reset_recorded()
    report = prewarm.run(spec, device="cpu")
    assert not [r for r in report["keys"] if r.get("error")], report
    assert {r["kind"] for r in report["keys"]} >= {"classic", "queue",
                                                   "cspade", "sweep"}
    assert report["backend"] == "cpu"
    assert set(shapes.recorded()) == set(report["enumerated"])
    return db, minsup, report


def test_prewarm_then_first_mine_has_no_drift(warmed):
    """After prewarm, the first service-default mines (plain and
    constrained, fresh engine caches) record only enumerated keys and
    build or load nothing."""
    from spark_fsm_tpu_torch.service.devcache import (
        CSpadeEngineCache, SpadeEngineCache)

    db, minsup, report = warmed
    c0 = compile_counts()
    s = {}
    got = SpadeEngineCache().mine(db, minsup, device="cpu", stats_out=s)
    assert s["store_cache_hit"] is False
    assert patterns_text(got) == patterns_text(mine_spade(db, minsup))
    got2 = CSpadeEngineCache().mine(db, minsup, maxgap=2, maxwindow=5,
                                    device="cpu", stats_out={})
    assert patterns_text(got2) == patterns_text(
        mine_cspade(db, minsup, maxgap=2, maxwindow=5))
    assert compile_counts() == c0
    assert shapes.drift(report["enumerated"]) == []


def test_prewarm_covers_streaming_pushes(warmed):
    db, _, report = warmed
    c0 = compile_counts()
    miner = TI.IncrementalWindowMiner(0.1, max_batches=3, seq_floor=BATCH,
                                      device="cpu")
    for i in range(3):
        miner.push(db[i * BATCH:(i + 1) * BATCH])
    assert compile_counts() == c0
    assert shapes.drift(report["enumerated"]) == []


def test_tsr_superbatch_keys_through_prewarm():
    db = _db(seed=81, n=90)
    vdb = build_vertical(db, min_item_support=1)
    spec = shapes.WorkloadSpec(n_sequences=len(db), n_items=vdb.n_items,
                               n_words=vdb.n_words, tsr=True)
    ekw = {"tsr_chunk": 256}
    targets = shapes.enumerate_shapes(spec, engine_kwargs=ekw, device="cpu")
    eval_keys = {k for k, t in targets.items() if t["kind"] == "tsr_eval"}
    ladder = RB.superbatch_geometries(32, 256)
    assert eval_keys == {shapes.key_tsr_eval(len(db), vdb.n_words, km, w)
                         for km, w in ladder}
    (tsr_t,) = [t for t in targets.values() if t["kind"] == "tsr"]
    assert tsr_t["superbatch"] == ladder

    shapes.reset_recorded()
    report = prewarm.run(spec, engine_kwargs=ekw, device="cpu")
    assert not [r for r in report["keys"] if r.get("error")]
    assert eval_keys <= set(shapes.recorded())
    eng = TT.TsrTorch(vdb, 8, 0.5, max_side=None, chunk=256, device="cpu")
    m = min(eng.item_cap, vdb.n_items)
    eng.chunk = eng._round_chunk(m)
    p1, s1 = eng._prep(m)
    cands = ([((0,), (j,)) for j in range(1, 9)]
             + [((0, 1), (2, 3)), ((0,), (1, 2, 3))])
    sups, _ = eng._resolve_eval(eng._dispatch_eval(p1, s1, cands))
    assert len(sups) == len(cands)
    assert shapes.drift(report["enumerated"]) == []


def test_tsr_resident_keys_through_prewarm():
    from spark_fsm_tpu_torch.models._common import device_hbm_budget
    import torch

    db = _db(seed=83, n=90)
    vdb = build_vertical(db, min_item_support=1)
    spec = shapes.WorkloadSpec(n_sequences=len(db), n_items=vdb.n_items,
                               n_words=vdb.n_words, tsr=True)
    ekw = {"tsr_chunk": 256}
    targets = shapes.enumerate_shapes(spec, engine_kwargs=ekw, device="cpu")
    res = {k for k, t in targets.items() if t["kind"] == "tsr_resident"}
    caps = RF.caps_for(len(db), vdb.n_words, vdb.n_items,
                       device_hbm_budget(torch.device("cpu")))
    want = set(RF.resident_keys(len(db), vdb.n_words, vdb.n_items, caps))
    assert res == want and res
    shapes.reset_recorded()
    report = prewarm.run(spec, engine_kwargs=ekw, device="cpu")
    assert not [r for r in report["keys"] if r.get("error")]
    assert want <= set(shapes.recorded())
    s = {}
    rules = TT.mine_tsr_torch(db, 8, 0.5, max_side=None, chunk=256,
                              resident="always", device="cpu", stats_out=s)
    assert rules and s.get("resident_segments", 0) >= 1
    assert shapes.drift(report["enumerated"]) == []


def test_tsr_partition_keys_through_prewarm():
    """The partitioned ladder without a mesh (every part on the one
    device): the ``tsr-part`` key and the inner ladder are enumerated as
    the reference enumerates them, prewarm records the key, and its warm
    mine leaves the ``fsm_partition_*`` families alone."""
    from spark_fsm_tpu_torch.parallel import partition as PN

    db = _db(seed=82, n=96)
    vdb = build_vertical(db, min_item_support=1)
    spec = dict(n_sequences=len(db), n_items=vdb.n_items,
                n_words=vdb.n_words, tsr=True, partition_parts=2)
    ekw = {"tsr_chunk": 256}
    targets = shapes.enumerate_shapes(shapes.WorkloadSpec(**spec),
                                      engine_kwargs=ekw, device="cpu")
    want = JSH.enumerate_shapes(JSH.WorkloadSpec(**spec), engine_kwargs=ekw)
    part = shapes.key_tsr_part(2, len(db), vdb.n_words)
    assert targets[part]["kind"] == want[part]["kind"] == "tsr_part"
    shapes.reset_recorded()
    mines0 = PN.tallies()
    report = prewarm.run(shapes.WorkloadSpec(**spec), engine_kwargs=ekw,
                         device="cpu")
    assert not [r for r in report["keys"] if r.get("error")]
    assert part in shapes.recorded()
    assert PN.tallies()["mines"] == mines0["mines"]
    s = {}
    TT.mine_tsr_torch(db, 8, 0.5, max_side=2, chunk=256, partition_parts=2,
                      device="cpu", stats_out=s)
    assert s["shape_key"] == part
    assert shapes.drift(report["enumerated"]) == []


def test_predict_keys_through_prewarm():
    spec = shapes.WorkloadSpec(n_sequences=0, n_items=0, predict_lanes=64,
                               predict_depth=8, predict_wave=4,
                               predict_topm=4)
    enumerated = sorted(shapes.enumerate_shapes(spec, device="cpu"))
    assert enumerated == [shapes.key_predict(64, 8, w, 4) for w in (1, 2, 4)]
    shapes.reset_recorded()
    report = prewarm.run(spec, device="cpu")
    assert not [r for r in report["keys"] if r.get("error")]
    assert set(enumerated) <= set(shapes.recorded())
    rules = [((1,), (2,), 3, 4), ((2, 3), (5,), 2, 6), ((1, 2), (7,), 1, 3)]
    trie = rule_trie.build_trie(rules, lanes_floor=64, depth_floor=8,
                                device="cpu")
    for prefixes in ([[1]], [[1], [2, 3]], [[1], [2, 3], [], [1, 2]]):
        assert len(rule_trie.score_wave(trie, prefixes, 4)) == len(prefixes)
    assert shapes.drift(enumerated) == []


# ---------------------------------------------------------------- service


@pytest.fixture(scope="module")
def servers():
    ref = JA.serve_background()
    port = TA.serve_background(device="cpu")
    yield ref, port
    for srv in (ref, port):
        srv.master.shutdown()
        srv.shutdown()


def _post(srv, endpoint, **params):
    data = urllib.parse.urlencode(params).encode()
    url = f"http://127.0.0.1:{srv.server_port}{endpoint}"
    with urllib.request.urlopen(url, data=data, timeout=300) as resp:
        return json.loads(resp.read().decode())


def test_admin_prewarm_and_shapes_endpoints(servers):
    """The same POST /admin/prewarm to both services gives the same report
    but for its walls; /admin/shapes bodies are equal; /admin/stats
    carries the per-key rows and the recorded key count."""
    db = _db(seed=80, n=60)
    vdb = build_vertical(db, min_item_support=6)
    params = dict(sequences=str(len(db)), items=str(vdb.n_items),
                  words=str(vdb.n_words), max_tokens="64")
    reports = []
    for reg, srv in zip((JSH, shapes), servers):
        reg.reset_recorded()
        reports.append(_post(srv, "/admin/prewarm", **params))
    keep = ("shape_key", "kind", "error")
    ref_r, port_r = (
        (r["enumerated"], r["backend"],
         [{k: row[k] for k in keep if k in row} for row in r["keys"]])
        for r in reports)
    assert port_r == ref_r
    assert port_r[2] and not [r for r in port_r[2] if "error" in r]
    for row in reports[1]["keys"]:
        assert set(row) >= {"shape_key", "kind", "wall_s", "fresh_compiles"}
    listings = [_post(srv, "/admin/shapes") for srv in servers]
    assert listings[1] == listings[0]
    assert listings[1]["drift"] == []
    stats = [_post(srv, "/admin/stats") for srv in servers]
    assert stats[1]["shape_keys_recorded"] == stats[0]["shape_keys_recorded"]
    assert ([r["shape_key"] for r in stats[1]["prewarm"]["keys"]]
            == [r["shape_key"] for r in stats[0]["prewarm"]["keys"]])
