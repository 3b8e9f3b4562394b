"""The port's service on a world of ranks against the reference's service
on a 2-device mesh, over HTTP, on the CPU.

Two worlds of 2 CPU ranks (gloo) are booted through the launcher as the
CLI boots them (``python -m spark_fsm_tpu_torch.service.app --config
... --device cpu``: rank 0 serves HTTP, rank 1 binds no port and replays
the mesh calls), one with ``[engine] mesh_devices = 2`` and one that also
sets ``[partition] parts = 2`` (one partition row a rank).  The
reference's service runs in this process with ``mesh_devices = 2`` on
the 8 virtual CPU devices of ``tests/conftest.py``.  The same requests
go to both: SPADE, SPAM, TSR and cSPADE ``/train`` jobs, a 2-part
partitioned TSR and a three-push ``/stream``; the ``/get`` and
``/predict`` bodies are byte-identical and ``/status`` equal but for the
keys ``test_torch_service.py`` excludes (the partitioned job: the
world-scoped ones).  The "mesh" world boots with ``[prewarm]`` at the
stream's envelope, and its sweeps show no drift.  Also: a cancel on the
leader ends a mine on every rank (the next job runs at once, long before
the world's timeout), ``/admin/stats`` reports the world, a
``[distributed]`` boot of one process a "host", worlds that cannot form
are refused, an idle world outlasts its timeout, a stream wider than the
prewarmed sweep rows drifts in the reference and not in the port, whose
miner splits the wide sweep (Queue C 5), the
``fsm_partition_*`` families are the reference's, and the partition
resolver counts what the reference counts (repairs R1 and R2: the mesh's
rank count, and controller processes, not ranks).
"""

import dataclasses
import json
import logging
import os
import socket
import subprocess
import sys
import time
import types

import pytest
import torch
import torch.distributed as dist

from spark_fsm_tpu import config as JC
from spark_fsm_tpu.service import app as JA
from spark_fsm_tpu.service import plugins as JP
from spark_fsm_tpu_torch import config as TC
from spark_fsm_tpu_torch.data.spmf import format_spmf
from spark_fsm_tpu_torch.data.synth import synthetic_db
from spark_fsm_tpu_torch.parallel.mesh import SeqMesh
from spark_fsm_tpu_torch.service import plugins as TP
from test_torch_service import (_assert_predict_equal, _assert_status_equal,
                                _await, _call, _db, _split_status)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOOT_S = 120.0
# the stream test's pushes: STREAM_BATCH sequences over ITEMS items; the
# "mesh" world's boot prewarm declares that envelope
STREAM_BATCH, ITEMS = 60, 20
WORLDS = {
    "mesh": {"engine": {"mesh_devices": 2},
             "prewarm": {"enabled": True,
                         "stream_batch_sequences": STREAM_BATCH,
                         "stream_seq_floor": STREAM_BATCH,
                         "stream_items": ITEMS}},
    "parts": {"engine": {"mesh_devices": 2},
              "partition": {"enabled": True, "parts": 2}},
}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _toml(cfg: dict) -> str:
    lines = []
    for section, body in cfg.items():
        lines.append(f"[{section}]")
        lines += [f"{k} = {str(v).lower() if isinstance(v, bool) else v}"
                  for k, v in body.items()]
    return "\n".join(lines) + "\n"


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """name -> (the world's leader as ``_call`` takes it, its process)."""
    out = {}
    try:
        for name, cfg in WORLDS.items():
            path = tmp_path_factory.mktemp(name) / "boot.toml"
            path.write_text(_toml(cfg))
            port = _free_port()
            # a world's CPU ranks share this host's cores with the tests
            proc = subprocess.Popen(
                [sys.executable, "-m", "spark_fsm_tpu_torch.service.app",
                 "--config", str(path), "--device", "cpu", "--port",
                 str(port)], cwd=REPO, stdout=subprocess.DEVNULL,
                stderr=subprocess.DEVNULL,
                env=dict(os.environ, OMP_NUM_THREADS="2"))
            out[name] = (types.SimpleNamespace(server_port=port), proc)
        deadline = time.time() + BOOT_S
        for name, (srv, proc) in out.items():
            while True:
                assert proc.poll() is None, f"world {name} exited"
                try:
                    if _call(srv, "/admin/ping")[0] == 200:
                        break
                except OSError:
                    pass
                assert time.time() < deadline, f"world {name} never served"
                time.sleep(0.1)
        yield {name: srv for name, (srv, _) in out.items()}
    finally:
        for _, proc in out.values():
            proc.terminate()
        for name, (_, proc) in out.items():
            try:
                # the leader stops its follower and ends the world
                assert proc.wait(timeout=60) == 0, name
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
                raise


@pytest.fixture(scope="module")
def reference():
    saved = JC.get_config()
    srv = JA.serve_background()
    yield srv
    srv.master.shutdown()
    srv.shutdown()
    JC.set_config(saved)


def _reference_config(world: str) -> None:
    # the port's "mesh" world pins its streams' batch stores to the
    # prewarmed bucket; so does the reference's service
    cfg = JC.Config(engine=JC.EngineConfig(mesh_devices=2),
                    prewarm=JC.PrewarmConfig(stream_seq_floor=STREAM_BATCH))
    if world == "parts":
        cfg = dataclasses.replace(
            cfg, partition=JC.PartitionConfig(enabled=True, parts=2))
    JC.set_config(cfg)


# a partitioned mine's stats on a world that are the world's, not the
# rank's: each rank folds only the engine counters of the parts it mined
# (the reference's one controller folds every part's), and its exchange
# bytes sum the rows' payloads (ROADMAP, known differences, PR 10)
WORLD_KEYS = ("algorithm", "sequences", "partition_parts",
              "partition_classes", "partition_imbalance",
              "partition_exchanges", "deepening_rounds", "results",
              "shape_key")


def _train_both(servers, uid, get, per_rank=False, **params):
    for srv in servers:
        code, body = _call(srv, "/train", uid=uid, **params)
        assert code == 200 and json.loads(body)["status"] == "started", body
    ref_st, port_st = (_await(s, uid) for s in servers)
    assert ref_st["status"] == "finished", ref_st
    if per_rank:
        (r_env, r_stats, r_err), (p_env, p_stats, p_err) = (
            _split_status(st) for st in (ref_st, port_st))
        assert (p_env, p_err) == (r_env, r_err)
        stats = {k: r_stats.get(k) for k in WORLD_KEYS}
        assert {k: p_stats.get(k) for k in WORLD_KEYS} == stats
    else:
        stats = _assert_status_equal(ref_st, port_st)
    ref_get, port_get = (_call(s, f"/get/{get}", uid=uid) for s in servers)
    assert port_get == ref_get
    assert json.loads(ref_get[1])["data"][get] != "[]"
    _assert_predict_equal(servers, uid, "1,2")
    return stats


JOBS = [
    ("mesh", "spade", "patterns", dict(algorithm="SPADE_TPU",
                                       support="0.05")),
    ("mesh", "spam", "patterns", dict(algorithm="SPAM_TPU", support="0.05")),
    ("mesh", "tsr", "rules", dict(algorithm="TSR_TPU", k="20",
                                  minconf="0.5")),
    ("mesh", "cspade", "patterns", dict(algorithm="SPADE_TPU",
                                        support="0.05", maxgap="2",
                                        maxwindow="5")),
    ("parts", "tsr", "rules", dict(algorithm="TSR_TPU", k="20",
                                   minconf="0.5", max_side="2")),
]


@pytest.mark.parametrize("world,name,get,params", JOBS,
                         ids=[f"{w}-{n}" for w, n, *_ in JOBS])
def test_world_bodies_equal_reference(worlds, reference, world, name, get,
                                      params):
    _reference_config(world)
    stats = _train_both((reference, worlds[world]), f"{world}-{name}", get,
                        per_rank=world == "parts", source="INLINE",
                        sequences=format_spmf(_db(6)), **params)
    if world == "parts":
        assert stats["partition_parts"] == 2


def test_world_stream_equals_reference(worlds, reference):
    """Three pushes into a window of two: each push a mesh call on the
    world (the incremental miner on both ranks)."""
    _reference_config("mesh")
    servers = (reference, worlds["mesh"])
    params = dict(support="0.2", max_batches="2", algorithm="SPADE_TPU")
    for push in range(3):
        seqs = format_spmf(synthetic_db(seed=40 + push,
                                        n_sequences=STREAM_BATCH,
                                        n_items=ITEMS, mean_itemsets=3.0))
        ref, port = (_call(s, "/stream/world", sequences=seqs, **params)
                     for s in servers)
        assert port == ref and ref[0] == 200, ref
        assert json.loads(ref[1])["status"] == "finished", ref
        ref_get, port_get = (_call(s, "/get/patterns", uid="stream:world")
                             for s in servers)
        assert port_get == ref_get
    ref_st, port_st = (json.loads(_call(s, "/status/stream:world")[1])
                       for s in servers)
    assert _assert_status_equal(ref_st, port_st)["route"] == "incremental"
    # the boot's prewarm covered the pushes' sweep geometries
    drift = json.loads(_call(servers[1], "/admin/shapes")[1])["drift"]
    assert [k for k in drift if k.startswith("sweep")] == []


def test_stream_prewarm_covers_a_wide_sweep(monkeypatch):
    """Queue C 5: a stream whose tracked tree's widest level outgrows the
    4 work-row buckets the ``[prewarm]`` envelope warms (an MSNBC-shaped
    stream at minsup 0.5 %).  The reference's incremental miner builds the
    wider store and drifts; the port's sweeps that level in pieces inside
    the top enumerated bucket, so it records no key beyond the
    enumeration, which stays the reference's.  The patterns after every
    push are byte-equal between the two miners."""
    from spark_fsm_tpu.service import prewarm as JW
    from spark_fsm_tpu.streaming.incremental import \
        IncrementalWindowMiner as JMiner
    from spark_fsm_tpu.utils import shapes as JS
    from spark_fsm_tpu.utils.canonical import patterns_text as j_text
    from spark_fsm_tpu_torch.data.synth import msnbc_like
    from spark_fsm_tpu_torch.service import prewarm as TW
    from spark_fsm_tpu_torch.streaming.incremental import \
        IncrementalWindowMiner
    from spark_fsm_tpu_torch.utils import shapes as TS
    from spark_fsm_tpu_torch.utils.canonical import patterns_text

    db = msnbc_like(scale=0.001, fast=True)
    per = len(db) // 4
    items = len({i for seq in db[:per] for its in seq for i in its})
    section = {"enabled": True, "stream_batch_sequences": per,
               "stream_seq_floor": per, "stream_items": items}
    monkeypatch.setattr(TS, "_recorded", {})
    monkeypatch.setattr(JS, "_recorded", {})
    miner = IncrementalWindowMiner(0.005, max_batches=5, seq_floor=per,
                                   device="cpu")
    j_miner = JMiner(0.005, max_batches=5, seq_floor=per)
    for i in range(4):
        batch = db[i * per:(i + 1) * per]
        assert patterns_text(miner.push(batch)) == j_text(
            j_miner.push(batch)), f"push {i + 1}"
    spec = TW.spec_from_config(TC.parse_config({"prewarm": section}).prewarm)
    enumerated = TS.enumerate_shapes(spec, device="cpu")
    j_spec = JW.spec_from_config(JC.parse_config({"prewarm": section}).prewarm)
    assert sorted(JS.enumerate_shapes(j_spec)) == sorted(enumerated)
    assert TS.drift(enumerated) == []
    assert JS.drift(enumerated) == ["sweep:s256w1r4096i128"]


def test_cancel_on_the_leader_ends_the_mine_on_every_rank(worlds):
    srv = worlds["mesh"]
    seqs = format_spmf(synthetic_db(seed=11, n_sequences=3000, n_items=80,
                                    mean_itemsets=6.0))
    code, body = _call(srv, "/train", uid="cancel-world", source="INLINE",
                       sequences=seqs, algorithm="TSR_TPU", k="3000",
                       minconf="0")
    assert code == 200, body
    deadline = time.time() + 60
    # DATASET is the last status before the mine's launches
    while json.loads(_call(srv, "/status/cancel-world")[1])["status"] \
            != "dataset":
        assert time.time() < deadline
        time.sleep(0.02)
    time.sleep(0.5)   # into the mine's launches
    t0 = time.time()
    code, body = _call(srv, "/admin/cancel/cancel-world")
    assert code == 200, body
    st = _await(srv, "cancel-world", timeout=60)
    assert st["status"] == "failure"
    assert st["data"]["error"].startswith("CANCELLED"), st
    # the follower left the mine at the same boundary: the next job's
    # collectives meet at once
    code, body = _call(srv, "/train", uid="after-cancel", source="INLINE",
                       sequences=format_spmf(_db(7)), algorithm="SPADE_TPU",
                       support="0.05")
    assert code == 200, body
    assert _await(srv, "after-cancel", timeout=60)["status"] == "finished"
    assert time.time() - t0 < 60


def test_admin_stats_report_the_world(worlds):
    for name, srv in worlds.items():
        stats = json.loads(_call(srv, "/admin/stats")[1])
        assert stats["mesh_devices"] == 2, name
        assert stats["devices"] == ["cpu", "cpu"], name
        assert stats["backend"] == "cpu"


def test_distributed_boot_one_process_a_host(tmp_path):
    """``[distributed]``: each "host" runs the CLI as its rank of the
    world (here two processes of this box); rank 0 serves, rank 1 binds
    no port, and a job mines on both."""
    http, rendezvous = _free_port(), _free_port()
    procs = []
    try:
        for rank in (0, 1):
            path = tmp_path / f"host{rank}.toml"
            path.write_text(_toml({"distributed": {
                "enabled": True, "num_processes": 2, "process_id": rank,
                "coordinator_address": f"'127.0.0.1:{rendezvous}'"}}))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "spark_fsm_tpu_torch.service.app",
                 "--config", str(path), "--device", "cpu", "--port",
                 str(http)], cwd=REPO, stdout=subprocess.DEVNULL,
                stderr=subprocess.DEVNULL,
                env=dict(os.environ, OMP_NUM_THREADS="2")))
        srv = types.SimpleNamespace(server_port=http)
        deadline = time.time() + BOOT_S
        while True:
            assert procs[0].poll() is None and procs[1].poll() is None
            try:
                if _call(srv, "/admin/ping")[0] == 200:
                    break
            except OSError:
                pass
            assert time.time() < deadline
            time.sleep(0.1)
        code, body = _call(srv, "/train", uid="hosts", source="INLINE",
                           sequences=format_spmf(_db(6)),
                           algorithm="SPADE_TPU", support="0.05")
        assert code == 200, body
        assert _await(srv, "hosts")["status"] == "finished"
        stats = json.loads(_call(srv, "/admin/stats")[1])
        assert (stats["mesh_devices"], stats["devices"]) == (2, ["cpu",
                                                                 "cpu"])
    finally:
        procs[0].terminate()
        # rank 0's teardown ends the world: rank 1 leaves with it
        assert [p.wait(timeout=60) for p in procs] == [0, 0]


@pytest.mark.parametrize("section,error", [
    ({"engine": {"mesh_devices": 3},
      "distributed": {"enabled": True, "num_processes": 2}},
     "cannot\\s+form a world"),
    ({"distributed": {"enabled": True, "num_processes": 2,
                      "process_id": 2}}, "is not a rank"),
    ({"distributed": {"enabled": True, "num_processes": 0}}, ">= 1"),
])
def test_a_world_that_cannot_form_is_refused(section, error):
    with pytest.raises(TC.ConfigError, match=error):
        TC.parse_config(section)


def test_partition_registry_families_match_the_reference():
    """The ``fsm_partition_*`` families and their zero-seeded series are
    the reference's; ``partition.tallies()`` reads them."""
    from spark_fsm_tpu.parallel import partition as JPN  # noqa: F401
    from spark_fsm_tpu.utils import obs as JO
    from spark_fsm_tpu_torch.parallel import partition as TPN
    from spark_fsm_tpu_torch.utils import obs as TO

    def families(registry):
        return sorted(k for k in registry.snapshot()
                      if k.startswith("fsm_partition_"))

    assert families(TO.REGISTRY) == families(JO.REGISTRY)
    for registry in (TO.REGISTRY, JO.REGISTRY):
        mines = registry.snapshot()["fsm_partition_mines_total"]
        assert {"algo=tsr", "algo=spade", "algo=cspade"} <= set(mines)
    before = TPN.tallies()
    TPN.count_mine("spam")
    TPN.plan_partitions([1, 2, 3], [5, 5, 5], 2, 4)
    after = TPN.tallies()
    assert after["mines"]["spam"] == before["mines"]["spam"] + 1
    assert after["plans"] == before["plans"] + 1


def test_an_idle_world_outlasts_its_timeout():
    """A follower waits for the leader's next mesh call as long as the
    service idles: past the world's own timeout, the call still lands."""
    import multiprocessing as mp

    import _torch_meshcall_worker as MW
    from spark_fsm_tpu_torch.parallel.launch import free_port

    ctx = mp.get_context("spawn")
    out_q = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=MW.idle_rank, args=(r, port, out_q))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        got = sorted(out_q.get(timeout=60) for _ in procs)
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    assert got == [(0, 7), (1, 7)]


def test_resolved_partition_parts_reads_the_meshs_ranks(monkeypatch):
    """R1: the resolver reads ``SeqMesh.size`` (the port's mesh has no
    ``devices``), for the reference's answers on 2 and 4 devices."""
    saved_j, saved_t = JC.get_config(), TC.get_config()
    try:
        for n, parts, want in ((2, 0, 2), (4, 0, 2), (4, 3, 0), (4, 2, 2)):
            part = dict(enabled=True, parts=parts)
            JC.set_config(JC.Config(engine=JC.EngineConfig(mesh_devices=n),
                                    partition=JC.PartitionConfig(**part)))
            TC.set_config(TC.Config(engine=TC.EngineConfig(mesh_devices=n),
                                    partition=TC.PartitionConfig(**part)))
            mesh = SeqMesh(dist.ProcessGroupGloo(dist.HashStore(), 0, 1), 0,
                           n, torch.device("cpu"))
            monkeypatch.setattr(TC, "get_mesh", lambda mesh=mesh: mesh)
            assert JP.resolved_partition_parts() == want
            assert TP.resolved_partition_parts() == want
    finally:
        JC.set_config(saved_j)
        TC.set_config(saved_t)


def test_partition_parts_count_controllers_not_ranks(monkeypatch, caplog):
    """R2: a rank of a 4-rank world on one host (``mesh_devices = 4``)
    resolves what the reference's single controller over 4 devices
    resolves: 2 for ``parts = 0``, and 0 with a
    ``partition_config_invalid`` log for ``parts = 3``."""
    saved_j, saved_t = JC.get_config(), TC.get_config()
    mesh = SeqMesh(dist.ProcessGroupGloo(dist.HashStore(), 0, 1), 0, 4,
                   torch.device("cpu"))
    monkeypatch.setattr(TC, "get_mesh", lambda: mesh)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 4)
    caplog.set_level(logging.INFO, logger="spark_fsm_tpu_torch")
    try:
        for parts, want in ((0, 2), (3, 0)):
            part = dict(enabled=True, parts=parts)
            JC.set_config(JC.Config(engine=JC.EngineConfig(mesh_devices=4),
                                    partition=JC.PartitionConfig(**part)))
            TC.set_config(TC.Config(engine=TC.EngineConfig(mesh_devices=4),
                                    partition=TC.PartitionConfig(**part)))
            caplog.clear()
            assert JP.resolved_partition_parts() == want
            assert TP.resolved_partition_parts() == want
            logged = [r for r in caplog.records
                      if r.name == "spark_fsm_tpu_torch"
                      and "partition_config_invalid" in r.getMessage()]
            assert bool(logged) == (parts == 3)
        # a [distributed] world of 4 hosts counts 4 controllers, as the
        # reference's jax.process_count() does
        TC.set_config(TC.Config(
            distributed=TC.DistributedConfig(enabled=True, num_processes=4),
            partition=TC.PartitionConfig(enabled=True)))
        assert TP._process_count() == 4
    finally:
        JC.set_config(saved_j)
        TC.set_config(saved_t)
