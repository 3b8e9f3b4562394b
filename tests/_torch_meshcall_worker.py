"""The rank side of ``tests/test_torch_service_world.py``'s idle-world
test: two gloo CPU ranks whose world times out after ``TIMEOUT_S``; the
leader idles past it before its one mesh call."""

from __future__ import annotations

import time

TIMEOUT_S = 2.0


def idle_rank(rank: int, port: int, out_q) -> None:
    from spark_fsm_tpu_torch.parallel.mesh import make_mesh
    from spark_fsm_tpu_torch.parallel.multihost import (
        init_distributed, shutdown_distributed)
    from spark_fsm_tpu_torch.service import meshcall

    try:
        init_distributed("gloo", f"tcp://127.0.0.1:{port}", 2, rank, "cpu",
                         timeout_s=TIMEOUT_S)
        meshcall._REPLAY["echo"] = lambda p: out_q.put((rank, p["x"]))
        meshcall.start(make_mesh(device="cpu"), leader=rank == 0)
        if rank == 0:
            time.sleep(3 * TIMEOUT_S)
            meshcall.call("echo", {"x": 7}, lambda: out_q.put((0, 7)))
            meshcall.stop()
        else:
            meshcall.follow()
        shutdown_distributed()
    except Exception as exc:  # the rank's boundary: report to the test
        out_q.put((rank, repr(exc)))
