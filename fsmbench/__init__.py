"""fsmbench: the benchmark of the PyTorch/CUDA port (``spark_fsm_tpu_torch``).

``python3 fsmbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on one CUDA card.
Everything a cell needs is found by name: its configuration in
``configs/<config>.json``, its traffic mix in ``traffic/<mix>.json``, the
algorithm's miner in ``algos/<algorithm>.py`` and each per-layer metric's
reader in ``metrics/<metric>.py``.  The plain reference that decides
``correct`` lives in ``reference/`` and imports nothing of the port.
"""
