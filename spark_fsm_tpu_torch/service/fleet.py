"""Fleet supervisor: the operator hook that acts on the autoscaler's
decisions (``service/autoscale.py``).

Port of ``scripts/fleet.py``.  The reference's script boots
``spark_fsm_tpu.service.app`` children; this one boots the port's
service, ``python -m spark_fsm_tpu_torch.service.app --config ...
--device DEV``, and hands every child the ``--device`` it was given
(default ``cuda``: a child that finds no card fails its boot, and the
supervisor never rewrites the device).  The rest is the reference's:

- the control plane splits deciding from supplying: the leader-elected
  controller inside the service publishes a desired-replica-count
  record (``fsm:autoscale:desired``) and drain directives; this
  supervisor boots and reaps processes on one host;
- it boots ``--initial`` replicas from one boot config, whose store must
  be ``redis`` (the shared journal and lease namespace is the fleet
  bus), read through the port's ``config.py``;
- it polls ``fsm:autoscale:desired`` and boots a replica (one a poll)
  while the live count is below the desired count, bounded by
  ``--max``.  Live = the un-expired ``fsm:replica:*`` heartbeat records
  (counted by cursor SCAN, never KEYS), plus this supervisor's own
  children that are alive but have no record yet (still booting): a
  restarted supervisor counts the replicas its predecessor orphaned and
  supplies only the deficit, and a boot longer than a poll is not
  booted twice.  The reference counts max(own children, heartbeats),
  which boots a duplicate beside heartbeating orphans while its own
  replica boots; here every child gets its ``--replica-id`` from the
  supervisor, so its record can be looked up;
- it reaps exited children: a scale-down victim drains and exits on its
  own (the supervisor kills nothing), and an exited replica below the
  desired count is replaced;
- SIGTERM/SIGINT forwards a drain-style SIGTERM to every child.

Usage::

    python -m spark_fsm_tpu_torch.service.fleet --config fleet.toml \\
        [--initial 2] [--max 8] [--poll 1.0] [--device cuda|cpu]

``--initial 0`` is the restart spelling: boot nothing up front, read
the live fleet from the heartbeats, supply only what the desired record
still wants.  Co-located replicas share one card: give each its share
of the engine pool in the boot config (``[engine] pool_bytes``).
"""

from __future__ import annotations

import argparse
import json
import signal
import subprocess
import sys
import time
import uuid
from typing import List, Optional


def log(msg: str) -> None:
    print(f"fleet: {msg}", flush=True)


def boot_replica(cfg_path: str, n: int, device: str,
                 replica_id: str) -> subprocess.Popen:
    proc = subprocess.Popen([sys.executable, "-m",
                             "spark_fsm_tpu_torch.service.app",
                             "--config", str(cfg_path), "--device", device,
                             "--replica-id", replica_id])
    proc.replica_id = replica_id
    log(f"booted replica #{n} (pid {proc.pid}, --device {device}, "
        f"replica {replica_id})")
    return proc


def live_heartbeats(client) -> int:
    """Un-expired ``fsm:replica:*`` records: the whole fleet's live count,
    replicas a previous (killed) supervisor orphaned included."""
    n, cursor = 0, "0"
    while True:
        cursor, batch = client.scan(cursor, match="fsm:replica:*", count=64)
        n += len(batch)
        if cursor == "0":
            return n


def booting(client, children: list) -> int:
    """Own children alive without a ``fsm:replica:{id}`` record yet: the
    replicas still booting, which no heartbeat counts."""
    return sum(1 for proc in children
               if client.get(f"fsm:replica:{proc.replica_id}") is None)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description="spark_fsm_tpu_torch fleet "
                                             "supervisor")
    ap.add_argument("--config", required=True,
                    help="replica boot config (.toml/.json); needs "
                         "[store] backend=redis and [cluster]/"
                         "[autoscale] enabled")
    ap.add_argument("--initial", type=int, default=None,
                    help="replicas to boot at start (default: "
                         "[autoscale] min_replicas; 0 = restart mode — "
                         "converge from the live heartbeats only)")
    ap.add_argument("--max", type=int, default=None,
                    help="hard replica ceiling (default: [autoscale] "
                         "max_replicas)")
    ap.add_argument("--poll", type=float, default=1.0)
    ap.add_argument("--device", default="cuda",
                    help="passed to every replica: cuda (default; a "
                         "replica without a card fails its boot) or cpu")
    args = ap.parse_args(argv)

    from spark_fsm_tpu_torch import config as cfgmod
    from spark_fsm_tpu_torch.service.resp import RespClient
    from spark_fsm_tpu_torch.utils import envelope

    cfg = cfgmod.load_config(args.config)
    if cfg.store.backend != "redis":
        sys.exit("fleet: the boot config must use [store] backend = "
                 "'redis' (the shared store is the fleet bus)")
    initial = args.initial if args.initial is not None \
        else max(1, cfg.autoscale.min_replicas)
    ceiling = args.max if args.max is not None \
        else max(initial or 1, cfg.autoscale.max_replicas)
    client = RespClient(host=cfg.store.host, port=cfg.store.port)

    children: list = []
    seq = 0
    # this supervisor's children are {tag}-{n}: unique across restarts
    tag = uuid.uuid4().hex[:8]
    stopping: list = []

    def _term(signum, frame):
        stopping.append(True)

    signal.signal(signal.SIGTERM, _term)
    signal.signal(signal.SIGINT, _term)

    for _ in range(initial):
        seq += 1
        children.append(boot_replica(args.config, seq, args.device,
                                     f"{tag}-{seq}"))
    desired = max(initial, 1)
    log(f"supervising {initial} replicas (ceiling {ceiling}), acting "
        f"on fsm:autoscale:desired")
    try:
        while not stopping:
            time.sleep(args.poll)
            for proc in list(children):
                rc = proc.poll()
                if rc is not None:
                    log(f"replica pid {proc.pid} exited rc={rc}")
                    children.remove(proc)
            try:
                raw = client.get("fsm:autoscale:desired")
                if raw:
                    # enveloped on the wire: a corrupt record reads as
                    # absent (keep the last desired count)
                    rec = json.loads(envelope.unwrap(raw)[0] or "{}")
                    want = int(rec.get("desired") or desired)
                    if want != desired:
                        log(f"desired-replica record: {want} "
                            f"(reason: {rec.get('reason')!r}, "
                            f"leader {rec.get('leader')!r})")
                    desired = want
            except Exception as exc:
                log(f"desired-record read failed: {exc}")
            try:
                live = live_heartbeats(client) + booting(client, children)
            except Exception as exc:
                log(f"heartbeat scan failed: {exc}")
                live = len(children)
            # one boot a poll: a fresh replica has no heartbeat record
            # until its boot ends; it counts as booting until then
            if live < min(desired, ceiling) and len(children) < ceiling:
                seq += 1
                children.append(boot_replica(args.config, seq, args.device,
                                             f"{tag}-{seq}"))
    finally:
        log("stopping fleet")
        for proc in children:
            if proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
        deadline = time.time() + 60.0
        for proc in children:
            try:
                proc.wait(max(0.1, deadline - time.time()))
            except subprocess.TimeoutExpired:
                proc.kill()
    return 0


if __name__ == "__main__":
    sys.exit(main())
