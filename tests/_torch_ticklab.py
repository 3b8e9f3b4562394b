"""How long one lease heartbeat tick of the port takes while worker
threads parse a FILE source (ROADMAP Queue C 14).

A ``LeaseManager`` holding three leases ticks twenty times on a
``MiniRedis`` reached over TCP, while ``BUSY`` threads parse an SPMF file
of the MSNBC-shaped database (a tenth of phase 13's, written once under
``OUT``) in a loop, with the interpreter's switch interval set to
``SWITCH`` seconds.  Prints the mean and longest tick and the store round
trips of one tick.  Run from the repository root::

    python3 tests/_torch_ticklab.py SWITCH BUSY OUT

It imports no jax and nothing of the reference.
"""

import os
import socket
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))


def main(switch: float, busy: int, out: str) -> None:
    from _torch_miniredis import MiniRedis
    from spark_fsm_tpu_torch.data.spmf import format_spmf, load_spmf
    from spark_fsm_tpu_torch.data.synth import msnbc_like
    from spark_fsm_tpu_torch.service.lease import LeaseManager
    from spark_fsm_tpu_torch.service.store import RedisResultStore

    path = os.path.join(out, "msnbc_tenth.spmf")
    if not os.path.exists(path):
        os.makedirs(out, exist_ok=True)
        with open(path, "w") as fh:
            fh.write(format_spmf(msnbc_like(scale=0.1, fast=True)))
    sys.setswitchinterval(switch)
    mini = MiniRedis()
    mgr = LeaseManager(RedisResultStore(port=mini.port), replica_id="lab",
                       lease_ttl_s=2.0, heartbeat_s=0)
    for uid in ("a", "b", "c"):
        mgr.acquire(uid)
    stop = threading.Event()

    def parse():
        while not stop.is_set():
            load_spmf(path)

    for _ in range(busy):
        threading.Thread(target=parse, daemon=True).start()
    time.sleep(0.5)
    walls = []
    for _ in range(20):
        t0 = time.perf_counter()
        mgr.tick()
        walls.append(time.perf_counter() - t0)
        time.sleep(0.1)
    stop.set()
    sends = [0]
    real = socket.socket.sendall

    def counted(self, *args, **kwargs):
        sends[0] += 1
        return real(self, *args, **kwargs)

    socket.socket.sendall = counted
    try:
        mgr.tick()
    finally:
        socket.socket.sendall = real
    mini.close()
    print(f"switch interval {switch} s, {busy} parsing threads: tick mean "
          f"{sum(walls) / len(walls):.4f} s, longest {max(walls):.4f} s; "
          f"{sends[0]} store round trips a tick")


if __name__ == "__main__":
    main(float(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
