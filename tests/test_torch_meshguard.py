"""The port's degraded-topology drills (``service/meshguard.py`` in the
partitioned routes) against the reference's ``tests/test_meshguard.py``.

- ADOPTION PARITY, one process: a device-shaped fault kills partition row
  0 (``dead_after=1``) in a 2-part TSR, SPADE or SPAM mine; the port at
  ``mesh=None`` (the parts in turn on the one device, the adopter
  rebuilt there) and the reference on its 8-device mesh each give the
  healthy run's text, and their guards the same dead rows and epoch.
- ADOPTION PARITY, a world: in a 2-rank gloo world of CPU ranks (one row
  a rank) the fault kills rank 0's row; rank 1 adopts part 0 from its
  last frontier through the round's exchange, both ranks give the
  healthy text, their guards agree, and the round takes one exchange
  more than a healthy round.
- A FAILED ROW on a world: a fault that is not device-shaped in rank 1's
  slice, or a cancel while rank 1 adopts rank 0's dead part, ends the TSR
  and SPAM mines with an error on both ranks at once (it travels in the
  exchange), and the next mines on the same world (the adoption drills)
  are healthy.
- The TSR engine's ``StaleTopology`` fence, a stale rebuild that keeps
  the row's health, a fault that is not device-shaped (raises, no row
  moves), ``max_retries`` exhausted (raises), and the card's own errors
  counted as device-shaped.
"""

import pytest

import _torch_meshguard_worker as W
from spark_fsm_tpu.config import MeshguardConfig as JMeshguardConfig
from spark_fsm_tpu.data.vertical import abs_minsup as j_abs_minsup
from spark_fsm_tpu.models import spam_bitmap as j_spam
from spark_fsm_tpu.models.spade_tpu import mine_spade_tpu
from spark_fsm_tpu.models.tsr import mine_tsr_tpu
from spark_fsm_tpu.parallel.mesh import make_mesh
from spark_fsm_tpu.service import meshguard as JMG
from spark_fsm_tpu.utils import faults as JF
from spark_fsm_tpu.utils.canonical import patterns_text as j_patterns_text
from spark_fsm_tpu.utils.canonical import rules_text as j_rules_text
from spark_fsm_tpu_torch.config import MeshguardConfig
from spark_fsm_tpu_torch.data.vertical import build_vertical
from spark_fsm_tpu_torch.models import spam_bitmap
from spark_fsm_tpu_torch.models.tsr import TsrPartitioned, TsrTorch
from spark_fsm_tpu_torch.parallel.launch import spawn_world
from spark_fsm_tpu_torch.service import fusion
from spark_fsm_tpu_torch.service import meshguard as MG
from spark_fsm_tpu_torch.utils import faults, obs
from spark_fsm_tpu_torch.utils.canonical import rules_text


def reference_text(name: str, mesh=None) -> str:
    """The reference's 2-part mine of drill ``name`` on ``mesh`` (None:
    its unpartitioned single-device mine, the healthy text)."""
    kw = {} if mesh is None else dict(mesh=mesh, partition_parts=2)
    if name == "tsr":
        return j_rules_text(mine_tsr_tpu(W.tsr_db(), 100, 0.5, max_side=2,
                                         **kw))
    if name == "spade":
        db = W.spade_db()
        return j_patterns_text(mine_spade_tpu(db, j_abs_minsup(0.06, len(db)),
                                              **kw))
    db = W.spam_db()
    return j_patterns_text(j_spam.mine_spam_tpu(
        db, j_abs_minsup(0.03, len(db)), partition_classes=16, **kw))


@pytest.fixture(scope="module")
def healthy():
    """Each drill's healthy text (the reference's unpartitioned mine)."""
    return {name: reference_text(name) for name in W.CASES}


@pytest.fixture(scope="module")
def world():
    """Each rank's drills in a 2-rank gloo world of CPU ranks."""
    return spawn_world(W.drill, 2, "gloo", "cpu", threads=1, timeout_s=600)


@pytest.fixture()
def spam_faults(monkeypatch):
    """Both packages' SPAM engines with a part-named fault site."""
    monkeypatch.setattr(spam_bitmap.SpamBitmapTorch, "mine",
                        W.faulty_mine(spam_bitmap.SpamBitmapTorch.mine,
                                      faults.fault_site))
    monkeypatch.setattr(j_spam.SpamBitmapTPU, "mine",
                        W.faulty_mine(j_spam.SpamBitmapTPU.mine,
                                      JF.fault_site))


def _reference_drill(name: str):
    guard = JMG.install(JMeshguardConfig(enabled=True, dead_after=1))
    try:
        JF.arm("device.dispatch", every=1, times=1, **W.MATCH[name])
        text = reference_text(name, make_mesh(8))
        return text, sorted(guard.dead_rows()), guard.current_epoch()
    finally:
        JF.disarm()
        JMG.reset()


def _port_drill(name: str):
    guard = MG.install(MeshguardConfig(enabled=True, dead_after=1))
    try:
        faults.arm("device.dispatch", every=1, times=1, **W.MATCH[name])
        replans = obs.REGISTRY.snapshot()["fsm_mesh_replans_total"]
        text, stats = W.mine_case(name, None, device="cpu")
        assert (obs.REGISTRY.snapshot()["fsm_mesh_replans_total"]
                == replans + 1)
        # one process: the adopter mines the part in the round, so the
        # exchanges stay one a round (one a mine for the slices)
        assert stats["partition_exchanges"] == stats.get(
            "deepening_rounds", 1)
        return text, sorted(guard.dead_rows()), guard.current_epoch()
    finally:
        faults.disarm()
        MG.reset()


@pytest.mark.parametrize("name", W.CASES)
def test_row_death_adoption_parity_one_process(healthy, spam_faults, name):
    ref_text, ref_dead, ref_epoch = _reference_drill(name)
    text, dead, epoch = _port_drill(name)
    assert ref_text == healthy[name] and text == healthy[name]
    assert dead == ref_dead == [0]
    assert epoch == ref_epoch == 1


@pytest.mark.parametrize("name", W.CASES)
def test_row_death_adoption_parity_world(world, healthy, name):
    for rank in world:
        got = rank[name]
        assert got["text"] == healthy[name], rank["rank"]
        assert got["dead"] == [0] and got["epoch"] == 1
        # the orphan's rows travel in a second exchange, in the one
        # round that lost a row
        assert got["exchanges"] == got["rounds"] + 1


@pytest.mark.parametrize("name", list(W.FAILURES))
def test_a_failed_row_ends_the_mine_on_every_rank(world, healthy, name):
    rank0, rank1 = world
    own = {"raise": "ValueError", "cancel": "Cancelled"}[name.split()[1]]
    other = {"raise": "RowFailed", "cancel": "RankAborted"}[
        name.split()[1]]
    assert rank1[name][0] == own and rank0[name][0] == other
    # at the exchange, not at the world's timeout (600 s)
    assert max(rank0[name][1], rank1[name][1]) < 120
    # the world mines on: its next mines (the adoption drills) are healthy
    for rank in world:
        for case in W.CASES:
            assert rank[case]["text"] == healthy[case], rank["rank"]


def _tsr_vdb():
    return build_vertical(W.tsr_db(), min_item_support=1)


def test_tsr_engine_refuses_a_stale_epoch():
    vdb = _tsr_vdb()
    guard = MG.install(MeshguardConfig(enabled=True, dead_after=1))
    try:
        eng = TsrTorch(vdb, 20, 0.5, device="cpu", max_side=2)
        assert eng._topo_epoch == 0
        guard.mark_dead(0)
        with pytest.raises(MG.StaleTopology) as ei:
            eng.mine()
        assert (ei.value.planned, ei.value.current) == (0, 1)
        # an engine built at the new epoch mines
        fresh = TsrTorch(vdb, 20, 0.5, device="cpu", max_side=2)
        assert rules_text(fresh.mine()) == rules_text(
            TsrTorch(vdb, 20, 0.5, device="cpu", max_side=2).mine())
        # the broker's entry refuses a stale wave too
        with pytest.raises(MG.StaleTopology):
            fusion.dispatch_wave("tsr", lambda: None, topology_epoch=0)
    finally:
        MG.reset()
    # with the plane off the engine stamps nothing and checks nothing
    assert TsrTorch(vdb, 20, 0.5, device="cpu")._topo_epoch is None


def test_stale_rebuild_keeps_the_rows_health(healthy):
    """An epoch bumped by another plan's row between construction and the
    mine: every part's first dispatch is refused, its engine rebuilt on
    the same row, and no row of this plan changes health."""
    vdb = _tsr_vdb()
    guard = MG.install(MeshguardConfig(enabled=True, dead_after=1))
    try:
        eng = TsrPartitioned(vdb, 100, 0.5, device="cpu", parts=2,
                             max_side=2)
        refused = obs.REGISTRY.snapshot()[
            "fsm_mesh_stale_epoch_refused_total"]
        guard.mark_dead(7)
        assert rules_text(eng.mine()) == healthy["tsr"]
        assert (obs.REGISTRY.snapshot()["fsm_mesh_stale_epoch_refused_total"]
                == refused + 2)
        assert [guard.state_of(r) for r in (0, 1)] == [MG.HEALTHY] * 2
        assert guard.dead_rows() == frozenset({7})
    finally:
        MG.reset()


def test_a_fault_that_is_not_device_shaped_raises():
    vdb = _tsr_vdb()
    guard = MG.install(MeshguardConfig(enabled=True, dead_after=1))
    try:
        faults.arm("device.dispatch", every=1, times=1, match="part0",
                   exc=ValueError)
        with pytest.raises(ValueError):
            TsrPartitioned(vdb, 100, 0.5, device="cpu", parts=2,
                           max_side=2).mine()
        assert guard.dead_rows() == frozenset()
        assert guard.state_of(0) == MG.HEALTHY
        assert guard.current_epoch() == 0
    finally:
        faults.disarm()
        MG.reset()


def test_max_retries_exhausted_raises():
    vdb = _tsr_vdb()
    guard = MG.install(MeshguardConfig(enabled=True, dead_after=5,
                                       max_retries=2))
    try:
        faults.arm("device.dispatch", every=1, match="part0")
        with pytest.raises(faults.FaultInjected):
            TsrPartitioned(vdb, 100, 0.5, device="cpu", parts=2,
                           max_side=2).mine()
        # one trip (suspect), then the second try is the last
        assert guard.state_of(0) == MG.SUSPECT
        assert faults.counters()["device.dispatch"]["injected"] >= 2
    finally:
        faults.disarm()
        MG.reset()


def test_the_cards_own_errors_are_device_shaped():
    """Where the reference names XLA's runtime errors, the port names the
    card's: torch's CUDA runtime errors and its OOM move a row's health;
    a plain error does not."""
    import torch

    accelerator = type("AcceleratorError", (RuntimeError,), {})
    for exc in (RuntimeError("CUDA error: an illegal memory access was "
                             "encountered"),
                accelerator("CUDA error: unspecified launch failure"),
                torch.cuda.OutOfMemoryError("CUDA out of memory.")):
        assert MG._device_shaped(exc), exc
    assert not MG._device_shaped(ValueError("bad request"))
    assert not MG._device_shaped(KeyError("missing"))
    assert JMG._device_shaped(RuntimeError("RESOURCE_EXHAUSTED: hbm"))
    assert MG._device_shaped(RuntimeError("RESOURCE_EXHAUSTED: hbm"))
