"""Host-only engine work a mine, in ms: the summed wall of the engines'
root seeding (``*.roots``), candidate lists (``*.candidates``),
prune-and-extend loops (``*.prune``) and final sort (``mine.sort``), spans
of the program's own (``fsmbench/spans.py``)."""

from fsmbench import spans

SITES = ("spade.roots", "spade.candidates", "spade.prune",
         "cspade.roots", "cspade.candidates", "cspade.prune", "mine.sort")


def install(rec):
    return spans.install(rec)


def read(rec):
    return spans.ms_per_mine(rec, SITES)
