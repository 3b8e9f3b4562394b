"""Every engine's mesh path against the reference's mesh and the port's one
device.

One 4-rank and one 3-rank (uneven padding) gloo world of CPU ranks are
spawned once each for the module (``parallel.launch.spawn_world``); every
rank runs every case of ``_torch_mesh_worker.CASES`` (the reference's own
mesh fixtures, SPADE and SPAM at two words, and a classic-engine
checkpoint resumed across the packages both ways).  For each case and
world size it checks that:

- the text equals the reference's mine on ``make_mesh(N)`` (the 8
  virtual CPU devices ``tests/conftest.py`` sets up), run here;
- the text equals the port's one-device mine;
- every rank gave the same text and stats;
- the stats, routing keys included, equal the reference's key for key,
  but for the known differences listed in ``ROADMAP.md``
  (``shape_key``, ``wait_s``, the push walls, and ``kernel_launches`` of
  the whole-mine engines).

On a mesh SPAM calls B1 and never B3, and TSR never takes the resident
route; both are asserted from call counters and stats.
"""

from concurrent.futures import ThreadPoolExecutor

import pytest

import _torch_mesh_worker as W
from spark_fsm_tpu.data.vertical import build_vertical as j_build_vertical
from spark_fsm_tpu.models import spade_fused as JF
from spark_fsm_tpu.models import spade_queue as JQ
from spark_fsm_tpu.models.spade_constrained import mine_cspade_tpu
from spark_fsm_tpu.models.spade_tpu import SpadeTPU, mine_spade_tpu
from spark_fsm_tpu.models.spam_bitmap import mine_spam_tpu
from spark_fsm_tpu.models.tsr import mine_tsr_tpu
from spark_fsm_tpu.parallel.mesh import make_mesh
from spark_fsm_tpu.streaming.incremental import (
    IncrementalWindowMiner as JIncremental)
from spark_fsm_tpu.utils.canonical import patterns_text as j_patterns_text
from spark_fsm_tpu.utils.canonical import rules_text as j_rules_text
from spark_fsm_tpu_torch.parallel.launch import spawn_world

SIZES = (4, 3)
NAMES = tuple(W.CASES)
# stats the port does not keep as the reference does (ROADMAP.md, "Known
# differences that are not faults")
UNSHARED = ("shape_key", "wait_s", "phase_s", "push_wall_s",
            "sweep_shape_keys")
# kernel_launches differs where the whole-mine engines count one B1
# launch a wave or level, and where a pinned chunk is narrower than a
# batch's candidates (B1 takes the batch in one launch)
LAUNCHES_DIFFER = ("queue", "dense", "dense_mesh_caps", "router_auto",
                   "spade_w2_auto", "classic_recompute")


def run_reference(name: str, mesh, resume=None) -> dict:
    """The reference's mine of case ``name`` on ``mesh``."""
    db, minsup = W.case_input(name)
    stats: dict = {}
    snapshot = None
    if name == "classic_recompute":
        vdb = j_build_vertical(db, min_item_support=minsup)
        eng = SpadeTPU(vdb, minsup, mesh=mesh, pool_bytes=1, node_batch=16,
                       chunk=64)
        text = j_patterns_text(eng.mine())
        stats = dict(eng.stats)
    elif name == "router_auto":
        text = j_patterns_text(mine_spade_tpu(db, minsup, mesh=mesh,
                                              stats_out=stats))
    elif name in ("queue", "dense", "dense_mesh_caps"):
        vdb = j_build_vertical(db, min_item_support=minsup)
        if name == "queue":
            eng = JQ.QueueSpadeTPU(vdb, minsup, mesh=mesh,
                                   caps=JQ.QueueCaps(**W.QUEUE_CAPS))
        else:
            caps = (JF.FusedCaps(**W.FUSED_CAPS) if name == "dense"
                    else None)
            eng = JF.FusedSpadeTPU(vdb, minsup, mesh=mesh, caps=caps)
        got = eng.mine()
        text = None if got is None else j_patterns_text(got)
        stats = dict(eng.stats)
    elif name in ("spade_w2_auto", "spade_w2_classic"):
        fused = "auto" if name.endswith("auto") else "never"
        text = j_patterns_text(mine_spade_tpu(db, minsup, mesh=mesh,
                                              fused=fused, stats_out=stats))
    elif name.startswith("spam"):
        extra = {"density_crossover": 0.5} if name == "spam_hybrid" else {}
        text = j_patterns_text(mine_spam_tpu(db, minsup, mesh=mesh,
                                             stats_out=stats, **extra))
    elif name.startswith("tsr"):
        side = 2 if name == "tsr_side2" else None
        text = j_rules_text(mine_tsr_tpu(db, W.TSR_K, W.TSR_MINCONF,
                                         mesh=mesh, max_side=side,
                                         stats_out=stats))
    elif name == "cspade":
        text = j_patterns_text(mine_cspade_tpu(db, minsup, mesh=mesh,
                                               stats_out=stats,
                                               **W.CSPADE_GAPS))
    elif name.startswith("incremental"):
        min_support, keep = W.INC_ARGS[name]
        wm = JIncremental(min_support, max_batches=keep, mesh=mesh)
        text, stats = [], []
        for batch in db:
            text.append(j_patterns_text(wm.push(batch)))
            stats.append(dict(wm.stats))
    elif name.startswith("checkpoint"):
        ck = W.Checkpoint(resume, every_s=0.0 if resume is None else 3600.0)
        text = j_patterns_text(mine_spade_tpu(
            db, minsup, mesh=mesh, fused="never", checkpoint=ck,
            stats_out=stats))
        snapshot = ck.saved[0] if ck.saved else None
    else:
        raise KeyError(name)
    return {"text": text, "stats": stats, "snapshot": snapshot}


def _shared(stats, name):
    if isinstance(stats, list):
        return [_shared(s, name) for s in stats]
    drop = UNSHARED + (("kernel_launches",) if name in LAUNCHES_DIFFER
                       else ())
    return {k: v for k, v in stats.items() if k not in drop}


@pytest.fixture(scope="module")
def worlds():
    """Per world size: the reference's results on ``make_mesh(N)``, each
    rank's results, and the port's one-device results.  Both worlds run
    while this process mines the reference's side."""
    meshes = {n: make_mesh(n) for n in SIZES}
    # the reference's first snapshot of each mesh, for the ranks to resume
    snaps = {n: run_reference("checkpoint_to_reference", meshes[n])
             for n in SIZES}
    resumes = {n: {"checkpoint_from_reference": snaps[n]["snapshot"]}
               for n in SIZES}
    with ThreadPoolExecutor(len(SIZES)) as pool:
        futures = {n: pool.submit(spawn_world, W.run_cases, n, "gloo", "cpu",
                                  (NAMES, resumes[n]), threads=1,
                                  timeout_s=600)
                   for n in SIZES}
        out = {}
        for n in SIZES:
            ref = {name: run_reference(name, meshes[n],
                                       resumes[n].get(name))
                   for name in NAMES if name != "checkpoint_to_reference"}
            ref["checkpoint_to_reference"] = snaps[n]
            one = {name: W.run_port(name, None, n, resumes[n].get(name))
                   for name in NAMES}
            out[n] = [ref, None, one, meshes[n]]
        for n in SIZES:
            out[n][1] = futures[n].result()
    return out


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("name", NAMES)
def test_mesh_mine_equals_reference_and_one_device(worlds, name, n):
    ref, ranks, one, _ = worlds[n]
    got = ranks[0][name]
    assert got["text"] is not None and got["text"] != ""
    # 1. the reference's mine on make_mesh(N)
    assert got["text"] == ref[name]["text"]
    # 2. the port's one-device mine
    assert got["text"] == one[name]["text"]
    # 3. every rank agrees
    for r, rank in enumerate(ranks[1:], 1):
        assert rank[name]["text"] == got["text"], r
        assert (_shared(rank[name]["stats"], name)
                == _shared(got["stats"], name)), r
    # 4. stats and routing keys, key for key
    assert _shared(got["stats"], name) == _shared(ref[name]["stats"], name)
    if name not in ("checkpoint_from_reference", "checkpoint_to_reference"):
        # supports were all-reduced on the way
        assert got["all_reduces"] > 0


@pytest.mark.parametrize("n", SIZES)
def test_checkpoint_resumes_across_packages(worlds, n):
    ref, ranks, one, mesh = worlds[n]
    full = ref["checkpoint_to_reference"]["text"]
    # the reference's snapshot resumed by the port's ranks
    assert ranks[0]["checkpoint_from_reference"]["text"] == full
    assert ranks[0]["checkpoint_from_reference"]["stats"]["resumed_nodes"] > 0
    # the port's mesh snapshot resumed by the reference's mesh mine
    snap = ranks[0]["checkpoint_to_reference"]["snapshot"]
    assert snap["stack"]
    for rank in ranks[1:]:
        assert rank["checkpoint_to_reference"]["snapshot"] == snap
    back = run_reference("checkpoint_from_reference", mesh, snap)
    assert back["text"] == full
    assert back["stats"]["resumed_nodes"] == len(snap["stack"])


@pytest.mark.parametrize("n", SIZES)
def test_spam_mesh_runs_b1_never_b3(worlds, n):
    _, ranks, _, _ = worlds[n]
    for rank in ranks:
        for name in ("spam_bitmap", "spam_hybrid", "spam_w2"):
            res = rank[name]
            assert res["calls"]["b1"] >= res["stats"]["waves"] > 0, name
            assert res["calls"]["b3"] == 0, name
        assert rank["spam_hybrid"]["stats"]["rep_idlist"] > 0


@pytest.mark.parametrize("n", SIZES)
def test_tsr_mesh_takes_the_host_loop(worlds, n):
    _, ranks, _, _ = worlds[n]
    for rank in ranks:
        for name in ("tsr_side2", "tsr_side_none"):
            res = rank[name]
            assert not res["stats"].get("resident")
            assert res["calls"]["b2"] > 0
            assert res["calls"]["b1"] == res["calls"]["b3"] == 0
