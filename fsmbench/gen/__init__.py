"""Input generation from a run's seed (``synth.py``)."""
