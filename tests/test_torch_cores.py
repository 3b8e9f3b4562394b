"""The port's CPU tests share the host's cores among pytest-xdist's
workers.

torch runs a CPU op on its pool of intra-op threads, one a core by
default, and the pool's threads spin while they wait for each other.  Six
workers with a pool of eight on an eight-core host keep about 48 such
threads busy, and a test of many small ops then runs 10 to 100 times
slower than alone: ``test_torch_partition.py``'s ``config3d`` case took
20 s alone and 207 s beside seven busy processes, and 41 s there with a
pool of one.  Every worker imports every test module when it collects,
so this module caps each worker's pool at its share of the cores before
any test runs; a run without workers keeps torch's default.
"""

import os

import torch

WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
SHARE = max(1, (os.cpu_count() or 1) // WORKERS)
if WORKERS > 1:
    torch.set_num_threads(SHARE)


def test_each_worker_takes_its_share_of_the_cores():
    if WORKERS > 1:
        assert torch.get_num_threads() == SHARE
    else:
        assert torch.get_num_threads() >= 1
