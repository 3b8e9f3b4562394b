"""The plain reference that decides a run's ``correct``.

Plain Python and NumPy only: nothing here imports ``jax``, the JAX package
or anything of the port (``spark_fsm_tpu_torch``), and nothing takes a
value the port derived.  It mines the same generated database the port is
given and works out its own vertical bitmaps (``vertical.py``).

- ``oracle.py``, ``maxstart_np.py``, ``bitops.py``: frozen copies of the
  repository's CPU oracles, the ground truth at small sizes (the tests);
- ``fast.py``: the same enumeration with each node's candidates counted in
  one array operation over the sequences where the node occurs, the
  reference a run compares against at full size.
"""
