"""Time the host blocks on the supports' copy-back a mine, in ms: the
summed wall of the engines' ``spade.wait`` and ``cspade.wait`` spans
(``fsmbench/spans.py``)."""

from fsmbench import spans

SITES = ("spade.wait", "cspade.wait")


def install(rec):
    return spans.install(rec)


def read(rec):
    return spans.ms_per_mine(rec, SITES)
