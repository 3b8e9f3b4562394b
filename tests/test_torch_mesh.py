"""The port's mesh geometry against the reference's, in one process.

For meshes of 1, 2, 3, 4 and 8 ranks and sequence counts that do and do
not divide by them, each function of the port's mesh half returns the
reference's numbers for ``make_mesh(N)`` (the 8 virtual CPU devices of
``tests/conftest.py``, the reference's path without Pallas): the rank's
block of the sequence axis against ``store_sharding``'s split, the
global axis, the classic, queue, dense, SPAM, cSPADE, TSR and sweep
geometry, ``FusedCaps.for_mesh`` and both routing tests.  A rank here is
a stand-in with the mesh's ``rank``, ``size`` and ``device``: the
geometry is host arithmetic and reads nothing else.  The module's last
tests drive the mesh primitives themselves on a 1-rank gloo mesh, the
sharded store build and the shard of a reference store, and a spawned
2-rank world one of whose ranks raises.
"""

import itertools
import types

import numpy as np
import pytest
import torch

from spark_fsm_tpu.models import _common as JCM
from spark_fsm_tpu.models import spade_constrained as JC
from spark_fsm_tpu.models import spade_fused as JF
from spark_fsm_tpu.models import spade_queue as JQ
from spark_fsm_tpu.models import spade_tpu as JS
from spark_fsm_tpu.models import spam_bitmap as JB
from spark_fsm_tpu.models import tsr as JT
from spark_fsm_tpu.parallel.mesh import make_mesh, store_sharding
from spark_fsm_tpu.streaming import incremental as JI
from spark_fsm_tpu_torch import interop
from spark_fsm_tpu_torch.models import _common as TCM
from spark_fsm_tpu_torch.models import spade as TS
from spark_fsm_tpu_torch.models import spade_constrained as TC
from spark_fsm_tpu_torch.models import spade_fused as TF
from spark_fsm_tpu_torch.models import spade_queue as TQ
from spark_fsm_tpu_torch.models import spam_bitmap as TB
from spark_fsm_tpu_torch.models import tsr as TT
from spark_fsm_tpu_torch.parallel import mesh as TM
from spark_fsm_tpu_torch.parallel import multihost as TMH
from spark_fsm_tpu_torch.streaming import incremental as TI

SIZES = (1, 2, 3, 4, 8)
SEQS = (1, 7, 96, 330, 4001, 77503, 990001)
ITEMS = (7, 300)
WORDS = (1, 3)
POOLS = (1, 8 << 20, 26 << 30)
CPU = torch.device("cpu")


def rank_of(n: int, r: int = 0):
    return types.SimpleNamespace(rank=r, size=n, device=CPU)


@pytest.fixture(scope="module")
def ref_meshes():
    return {n: make_mesh(n) for n in SIZES}


@pytest.mark.parametrize("n", SIZES)
def test_shard_bounds_equal_store_sharding(ref_meshes, n):
    for s in SEQS:
        n_seq = TCM.device_axes(s, mesh=rank_of(n))
        shape = (3, n_seq, 2)
        imap = store_sharding(ref_meshes[n]).devices_indices_map(shape)
        blocks = [imap[d][1] for d in ref_meshes[n].devices.flat]
        for r, sl in enumerate(blocks):
            want = (sl.start or 0, n_seq if sl.stop is None else sl.stop)
            assert TM.shard_bounds(n_seq, rank_of(n, r)) == want, (s, r)
        # the blocks tile the axis; each rank's padded local width holds
        # its block and is a whole number of B1's sequence tiles
        w = TCM.shard_width(n_seq, rank_of(n))
        assert w >= n_seq // n and w % 32 == 0
    with pytest.raises(ValueError):
        TM.shard_bounds(7, rank_of(2))


@pytest.mark.parametrize("n", SIZES)
def test_device_axes_equal_reference(ref_meshes, n):
    for s, buckets in itertools.product(SEQS, (False, True)):
        want = JCM.device_axes(s, 7, 1, mesh=ref_meshes[n],
                               shape_buckets=buckets)[0]
        assert TCM.device_axes(s, buckets, rank_of(n)) == want, (s, buckets)


@pytest.mark.parametrize("n", SIZES)
def test_classic_spam_cspade_geometry_equal_reference(ref_meshes, n):
    jm, tm = ref_meshes[n], rank_of(n)
    for s, ni, w, pool in itertools.product(SEQS, ITEMS, WORDS, POOLS):
        kw = dict(pool_bytes=pool)
        got = TS.classic_geometry(s, ni, w, mesh=tm, **kw)
        want = JS.classic_geometry(s, ni, w, mesh=jm, **kw)
        for key in ("n_seq", "chunk", "recompute_chunk", "pipeline_depth",
                    "node_batch", "pool_slots"):
            assert got[key] == want[key], (key, s, ni, w, pool)
        got = TB.spam_geometry(s, ni, w, mesh=tm, node_batch=64, **kw)
        want = JB.spam_geometry(s, ni, w, mesh=jm, node_batch=64, **kw)
        for key in ("n_seq", "ni_pad", "node_batch", "pipeline_depth",
                    "pool_slots", "chunk"):
            assert got[key] == want[key], (key, s, ni, w, pool)
        got = TC.cspade_geometry(s, ni, w, mesh=tm, **kw)
        want = JC.cspade_geometry(s, ni, w, mesh=jm, **kw)
        for key in ("n_seq", "item_rows", "n_pos", "state_bits", "chunk",
                    "recompute_chunk", "pipeline_depth", "node_batch",
                    "pool_slots"):
            assert got[key] == want[key], (key, s, ni, w, pool)


@pytest.mark.parametrize("n", SIZES)
def test_tsr_and_sweep_geometry_equal_reference(ref_meshes, n):
    jm, tm = ref_meshes[n], rank_of(n)
    for s, w, buckets in itertools.product(SEQS, WORDS, (False, True)):
        assert (TT.tsr_geometry(s, shape_buckets=buckets, mesh=tm)["n_seq"]
                == JT.tsr_geometry(s, w, mesh=jm,
                                   shape_buckets=buckets)["n_seq"])
        got = TI.sweep_geometry(s, w, mesh=tm)
        want = JI.sweep_geometry(s, w, mesh=jm)
        assert (got["n_seq"], got["n_words"]) == (want["n_seq"],
                                                  want["n_words"]), (s, w)


def _pin_budget(monkeypatch, budget):
    """Both packages' whole-mine engines read one device budget."""
    for mod in (JQ, JF, TQ, TF):
        monkeypatch.setattr(mod, "device_hbm_budget", lambda *_: budget,
                            raising=False)
    monkeypatch.setattr(JCM, "device_hbm_budget", lambda *_: budget)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("budget", [1 << 30, 76 << 30])
def test_whole_mine_caps_and_routes_equal_reference(monkeypatch, ref_meshes,
                                                    n, budget):
    _pin_budget(monkeypatch, budget)
    jm, tm = ref_meshes[n], rank_of(n)
    assert vars(TF.FusedCaps.for_mesh(tm)) == vars(JF.FusedCaps.for_mesh(jm))
    for s, ni, w in itertools.product(SEQS, ITEMS, WORDS):
        got = TQ.queue_geometry(s, ni, w, mesh=tm)
        want = JQ.queue_geometry(s, ni, w, mesh=jm)
        assert (got["n_seq"], got["ni_pad"], got["nb_late"]) == (
            want["n_seq"], want["ni_pad"], want["nb_late"])
        assert vars(got["caps"]) == vars(want["caps"]), (s, ni, w)
        got = TF.fused_geometry(s, ni, w, mesh=tm)
        want = JF.fused_geometry(s, ni, w, mesh=jm)
        assert (got["n_seq"], got["ni_pad"]) == (want["n_seq"],
                                                 want["ni_pad"])
        assert vars(got["caps"]) == vars(want["caps"])
    decisions = set()
    for s, ni, w, buckets in itertools.product(
            (4000, 65537, 300001, 990000, 3_000_001), (7, 61, 300, 1100),
            (1, 3), (False, True)):
        vdb = types.SimpleNamespace(n_sequences=s, n_items=ni, n_words=w)
        q = TQ.queue_eligible(vdb, mesh=tm, shape_buckets=buckets)
        f = TF.fused_eligible(vdb, mesh=tm, shape_buckets=buckets)
        assert q == JQ.queue_eligible(vdb, mesh=jm, shape_buckets=buckets)
        assert f == JF.fused_eligible(vdb, mesh=jm, shape_buckets=buckets)
        decisions.add((q, f))
    # the grid reaches both answers of each test
    assert {q for q, _ in decisions} == {True, False}
    assert {f for _, f in decisions} == {True, False}


def test_local_mesh_reduces_and_counts():
    mesh = TM.local_mesh("cpu")
    assert (mesh.rank, mesh.size, mesh.backend) == (0, 1, "gloo")
    t = torch.arange(5, dtype=torch.int32)
    assert TM.all_reduce_sum(t, mesh) is t and t.tolist() == [0, 1, 2, 3, 4]
    assert TM.all_reduce_sum(t, None) is t
    assert TM.rank0_decides(True, mesh) and not TM.rank0_decides(False, mesh)
    stats = mesh.reduce_stats()
    assert stats["all_reduces"] == 1 and stats["all_reduce_ms"] >= 0
    mesh.reset_counters()
    assert mesh.reduce_stats()["all_reduces"] == 0
    assert TMH.is_multihost(mesh) is False and TMH.is_multihost(None) is False
    x = TMH.host_to_device(mesh, np.arange(3))
    assert x.device == CPU and x.tolist() == [0, 1, 2]
    with pytest.raises(ValueError):
        TM.all_reduce_sum(torch.zeros(4, 4, dtype=torch.int32).t(), mesh)
    with pytest.raises(ValueError):
        TM.make_mesh(2, group=mesh.group, device="cpu")


def test_shard_store_from_numpy_gives_the_rank_block():
    rng = np.random.default_rng(0)
    n, words = 3, 2
    arr = rng.integers(0, 1 << 32, (5, 12 * words), dtype=np.uint32)
    for r in range(n):
        m = rank_of(n, r)
        lo, hi = TM.shard_bounds(12, m)
        got = interop.shard_store_from_numpy(arr, m, words, width=32)
        back = interop.store_to_numpy(got)
        assert back.shape == (5, 32 * words)
        assert np.array_equal(back[:, :(hi - lo) * words],
                              arr[:, lo * words:hi * words])
        assert not back[:, (hi - lo) * words:].any()


def test_sharded_store_build_is_the_block_of_the_whole():
    """Each rank's scatter of its tokens equals its block of the one-device
    store (the reference's shard scatter)."""
    from spark_fsm_tpu_torch.data.synth import synthetic_db
    from spark_fsm_tpu_torch.data.vertical import build_vertical

    db = synthetic_db(seed=5, n_sequences=101, n_items=9, mean_itemsets=5.0)
    vdb = build_vertical(db, min_item_support=1)
    rows, w = vdb.n_items + 3, vdb.n_words
    for n in (1, 3, 4):
        n_seq = TCM.device_axes(vdb.n_sequences, mesh=rank_of(n))
        whole = TCM.scatter_build_store(vdb, rows, n_seq, w, CPU)
        for r in range(n):
            m = rank_of(n, r)
            got = TCM.scatter_build_store(vdb, rows, n_seq, w, CPU, m)
            want = interop.shard_store_from_numpy(
                interop.store_to_numpy(whole), m, w,
                width=TCM.shard_width(n_seq, m))
            assert torch.equal(got, want), (n, r)


def test_spawn_world_fails_with_the_failing_ranks_traceback():
    import _torch_mesh_worker as W
    from spark_fsm_tpu_torch.parallel.launch import spawn_world

    with pytest.raises(RuntimeError, match="rank 1 of 2 failed(.|\n)*"
                                           "rank 1 refuses"):
        spawn_world(W.fail_on_rank, 2, "gloo", "cpu", (1,), threads=1,
                    timeout_s=120)
