"""The port's replicated service across packages and processes, on the CPU.

- Cross-package adoption: a reference ``Miner`` checkpoints a SPADE mine
  on a Redis-protocol store and dies after its first frontier save; its
  lease expires on a virtual clock; a port ``Miner`` (engines on the CPU)
  on the same store adopts the orphan only then, under a higher fencing
  token, resumes the reference's frontier on its own queue engine and
  finishes with the oracle's text.
  A fleet moved from the TPU to the card one replica at a time depends
  on exactly this.
- The fleet supervisor (``spark_fsm_tpu_torch/service/fleet.py``):
  restart-mode convergence with ``--device cpu`` replicas on a MiniRedis
  (``scripts/fleet_smoke.py``'s drill: boot two, publish a desired count
  of three, SIGKILL the supervisor mid-scale-up, restart it with
  ``--initial 0``; the fleet converges to three live heartbeats with no
  duplicate and every accepted job settles once with parity; then, with
  one orphan gone, a restarted supervisor boots the third replica itself
  and counts it while it boots, so no fourth is booted), its
  refusal of a store that is not ``redis``, and a default ``--device
  cuda`` that it passes on unchanged, so a replica without a card fails
  its boot."""

import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from pathlib import Path

from _torch_cluster_rig import (DRILL_TIMEOUT_S, PKGS, PortOnCpu,
                                await_terminal, text_of)
from _torch_miniredis import MiniRedis, SnoopingMiniRedis

ROOT = Path(__file__).resolve().parent.parent
BOOT_TIMEOUT_S = 120.0


class _Kill(BaseException):
    """A hard kill of the reference replica's worker: a BaseException, so
    no supervision layer settles anything on its way out."""


def test_port_adopts_a_reference_replicas_checkpointed_mine(monkeypatch):
    R, T = PKGS["reference"], PKGS["port"]
    t = [0.0]
    clock = lambda: t[0]  # noqa: E731
    mini = SnoopingMiniRedis(clock=clock)
    db = T.synth.synthetic_db(seed=53, n_sequences=160, n_items=12,
                              mean_itemsets=3.0, mean_itemset_size=1.3)
    want = T.canonical.patterns_text(T.oracle.mine_spade(
        db, T.vertical.abs_minsup(0.05, len(db))))
    saved = threading.Event()
    real_save = R.actors.StoreCheckpoint.save

    def save_then_die(self, state):
        real_save(self, state)
        saved.set()
        raise _Kill

    monkeypatch.setattr(R.actors.StoreCheckpoint, "save", save_then_die)
    died = threading.Event()
    hook = threading.excepthook

    def worker_death(args):
        if args.exc_type is _Kill:
            died.set()
        else:
            hook(args)

    monkeypatch.setattr(threading, "excepthook", worker_death)
    ref_store = R.store.RedisResultStore(port=mini.port)
    ref_mgr = R.lease.LeaseManager(ref_store, replica_id="rep-ref",
                                   lease_ttl_s=2.0, heartbeat_s=0,
                                   clock=clock)
    ref_miner = R.actors.Miner(ref_store, workers=1, lease_mgr=ref_mgr)
    port_miner = None
    try:
        ref_miner.submit(R.model.ServiceRequest("fsm", "train", {
            "algorithm": "SPADE_TPU", "source": "INLINE",
            "sequences": R.spmf.format_spmf(db), "support": "0.05",
            "checkpoint": "1", "checkpoint_every_s": "0", "uid": "move"}))
        assert saved.wait(DRILL_TIMEOUT_S), "no frontier save"
        assert died.wait(DRILL_TIMEOUT_S), "the worker outlived the kill"
        assert ref_store.patterns("move") is None
        intent = json.loads(R.envelope.unwrap(
            ref_store.journal_get("move"))[0])
        assert intent["replica"] == "rep-ref"

        with PortOnCpu():
            store = T.store.RedisResultStore(port=mini.port)
            mgr = T.lease.LeaseManager(store, replica_id="rep-port",
                                       lease_ttl_s=2.0, heartbeat_s=0,
                                       clock=clock)
            port_miner = T.actors.Miner(store, workers=1, lease_mgr=mgr)

            class _Master:
                pass

            master = _Master()
            master.store, master.miner = store, port_miner
            # the lease is live: the dead replica's job is not ours yet
            assert T.actors.recover_orphans(master)["resumed"] == []
            t[0] = 2.5  # the reference replica's lease expires
            report = T.actors.recover_orphans(master)
            assert report["resumed"] == ["move"], report
            assert await_terminal(store, "move") == "finished", \
                store.get("fsm:error:move")
        assert text_of(T, store.patterns("move")) == want
        stats = json.loads(T.envelope.unwrap(store.get("fsm:stats:move"))[0])
        assert stats["fused"] == "queue" and stats["resumed_nodes"] > 0
        assert store.journal_uids() == []
        # the lease is released after the terminal status lands: wait for
        # the release itself, not the status
        deadline = time.time() + 10.0
        while (time.time() < deadline
               and store.peek("fsm:lease:move") is not None):
            time.sleep(0.05)
        assert store.peek("fsm:lease:move") is None
        assert [s for _, s in store.status_log("move")
                if s in ("finished", "failure")] == ["finished"]
        # the lease's fencing tokens rise from the reference's holder to
        # the port's: one INCR sequence across both packages
        holders = [(tok, rep) for uid, tok, rep in mini.lease_sets
                   if uid == "move"]
        assert holders[0][1] == "rep-ref" and holders[-1][1] == "rep-port"
        assert all(a[0] < b[0] for a, b in zip(holders, holders[1:])), \
            holders
    finally:
        if port_miner is not None:
            port_miner.shutdown()
        ref_miner.shutdown()
        mini.close()


# ------------------------------------------------------ fleet supervisor


class _Fleet:
    """One supervisor process; a thread drains its stdout (which its
    replicas inherit) and harvests replica pids and HTTP ports."""

    def __init__(self, cfg_path, *extra):
        env = dict(os.environ, PYTHONPATH=str(ROOT))
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "spark_fsm_tpu_torch.service.fleet",
             "--config", str(cfg_path), "--max", "4", "--poll", "0.3",
             *extra], cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, bufsize=1)
        self.lines, self.pids, self.ports = [], [], []
        threading.Thread(target=self._drain, daemon=True).start()

    def _drain(self):
        for line in self.proc.stdout:
            self.lines.append(line)
            m = re.search(r"booted replica #\d+ \(pid (\d+)", line)
            if m:
                self.pids.append(int(m.group(1)))
            m = re.search(r"service on http://[^:]+:(\d+)", line)
            if m:
                self.ports.append(int(m.group(1)))

    def stop(self):
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
        try:
            self.proc.wait(60)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()


def _wait_for(cond, timeout, what):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return
        time.sleep(0.1)
    raise AssertionError(f"timed out waiting for {what}")


def _post(port, endpoint, **params):
    data = urllib.parse.urlencode(params).encode()
    url = f"http://127.0.0.1:{port}{endpoint}"
    try:
        with urllib.request.urlopen(url, data=data, timeout=60) as resp:
            return resp.status, json.loads(resp.read().decode())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read().decode())


def _fleet_config(tmp_path, mini_port, backend="redis"):
    path = tmp_path / "fleet.json"
    path.write_text(json.dumps({
        "service": {"port": 0, "miner_workers": 1, "queue_depth": 16},
        "store": {"backend": backend, "host": "127.0.0.1",
                  "port": mini_port},
        "cluster": {"enabled": True, "lease_ttl_s": 2.0,
                    "recover_every_s": 0.5},
        # the controller runs but holds: the test writes the desired
        # record itself, standing in for the leader's decision
        "autoscale": {"enabled": True, "min_replicas": 1,
                      "max_replicas": 4, "hold_s": 3600.0,
                      "cooldown_s": 3600.0}}))
    return path


def _cmdline(pid):
    try:
        return Path(f"/proc/{pid}/cmdline").read_bytes().split(b"\0")
    except OSError:
        return None


def test_fleet_restart_mode_converges_without_duplicates(tmp_path):
    T = PKGS["port"]
    mini = MiniRedis()
    client = T.resp.RespClient(port=mini.port)
    cfg = _fleet_config(tmp_path, mini.port)
    fleets = []

    def live():
        from spark_fsm_tpu_torch.service.fleet import live_heartbeats

        return live_heartbeats(client)

    try:
        first = _Fleet(cfg, "--initial", "2", "--device", "cpu")
        fleets.append(first)
        _wait_for(lambda: len(first.ports) >= 2 and live() >= 2,
                  BOOT_TIMEOUT_S, "the first two replicas")
        # every replica runs with the device the supervisor was given
        for pid in first.pids:
            argv = _cmdline(pid)
            assert argv is not None and argv[argv.index(b"--device") + 1] \
                == b"cpu", argv
        db = T.synth.synthetic_db(seed=77, n_sequences=100, n_items=10,
                                  mean_itemsets=2.5, mean_itemset_size=1.2)
        want = T.canonical.patterns_text(T.oracle.mine_spade(
            db, T.vertical.abs_minsup(0.1, len(db))))
        accepted = []
        for i, extra in enumerate([{}, {"checkpoint": "1",
                                        "checkpoint_every_s": "0"}, {}]):
            code, body = _post(first.ports[i % 2], "/train",
                               uid=f"fleet-job-{i}", algorithm="SPADE_TPU",
                               source="INLINE", support="0.1",
                               sequences=T.spmf.format_spmf(db), **extra)
            assert code == 200 and body["status"] == "started", body
            accepted.append(f"fleet-job-{i}")
        client.set("fsm:autoscale:desired", json.dumps(
            {"desired": 3, "dir": "up", "reason": "restart drill",
             "leader": "test", "seq": 1, "ts": round(time.time(), 3)}))
        _wait_for(lambda: len(first.pids) >= 3, BOOT_TIMEOUT_S,
                  "the supervisor to start the third replica")
        first.proc.send_signal(signal.SIGKILL)  # mid-scale-up
        first.proc.wait(30)
        _wait_for(lambda: all(client.get(f"fsm:status:{u}") in
                              ("finished", "failure") for u in accepted),
                  DRILL_TIMEOUT_S, "the jobs on the orphaned replicas")
        # the half-booted third replica finishes its boot without a
        # supervisor; the restarted one must count it, not duplicate it
        # (it counts heartbeats, so a replica still booting when it starts
        # would be booted twice: ROADMAP Queue C 6)
        _wait_for(lambda: live() >= 3, BOOT_TIMEOUT_S,
                  "the orphaned third replica's heartbeat")

        second = _Fleet(cfg, "--initial", "0", "--device", "cpu")
        fleets.append(second)
        _wait_for(lambda: any("supervising 0 replicas" in line
                              for line in second.lines),
                  BOOT_TIMEOUT_S, "the restarted supervisor")
        time.sleep(2.0)  # several polls: no duplicate next to the orphans
        assert live() == 3 and second.pids == [], second.lines
        assert [pid for pid in first.pids if _cmdline(pid)] == first.pids
        for uid in accepted:
            entries = [e.partition(":")[2]
                       for e in client.lrange(f"fsm:status:log:{uid}")]
            assert [e for e in entries if e in ("finished", "failure")] \
                == ["finished"], (uid, entries)
            assert text_of(T, client.get(f"fsm:pattern:{uid}")) == want
        assert client.keys("fsm:journal:*") == []
        assert client.keys("fsm:admission:*") == []

        # the racing case (ROADMAP Queue C 6): two heartbeating orphans,
        # and the third replica booted by a restarted supervisor itself,
        # whose boot outlasts several polls: the supervisor counts its
        # booting child and boots no fourth
        second.stop()
        os.kill(first.pids[-1], signal.SIGTERM)
        _wait_for(lambda: live() == 2, BOOT_TIMEOUT_S,
                  "one orphan to leave the fleet")
        third = _Fleet(cfg, "--initial", "0", "--device", "cpu")
        fleets.append(third)
        _wait_for(lambda: third.pids, BOOT_TIMEOUT_S,
                  "the restarted supervisor's boot")
        t_boot = time.time()
        _wait_for(lambda: live() >= 3, BOOT_TIMEOUT_S,
                  "the booted replica's heartbeat")
        assert time.time() - t_boot > 0.3  # longer than one --poll
        time.sleep(2.0)  # several polls
        assert live() == 3 and len(third.pids) == 1, third.lines
    finally:
        for fleet in fleets:
            fleet.stop()
        for fleet in fleets:
            for pid in fleet.pids:  # the killed supervisor's orphans
                try:
                    os.kill(pid, signal.SIGTERM)
                except OSError:
                    pass
        deadline = time.time() + 60
        for fleet in fleets:
            for pid in fleet.pids:
                while _cmdline(pid) and time.time() < deadline:
                    time.sleep(0.1)
        client.close()
        mini.close()


def test_fleet_refuses_a_store_that_is_not_redis(tmp_path):
    cfg = _fleet_config(tmp_path, 1, backend="inproc")
    proc = subprocess.run(
        [sys.executable, "-m", "spark_fsm_tpu_torch.service.fleet",
         "--config", str(cfg), "--device", "cpu"], cwd=str(ROOT),
        env=dict(os.environ, PYTHONPATH=str(ROOT)), capture_output=True,
        text=True, timeout=120)
    assert proc.returncode != 0
    assert "[store] backend = 'redis'" in proc.stderr


def test_fleet_passes_cuda_on_and_a_replica_without_a_card_fails(tmp_path):
    mini = MiniRedis()
    fleet = _Fleet(_fleet_config(tmp_path, mini.port), "--initial", "1")
    try:
        _wait_for(lambda: any("exited rc=1" in line for line in fleet.lines),
                  BOOT_TIMEOUT_S, "the replica's failed boot")
        assert all("--device cuda" in line for line in fleet.lines
                   if "booted replica" in line)
        assert not fleet.ports  # no replica ever served
    finally:
        fleet.stop()
        mini.close()
