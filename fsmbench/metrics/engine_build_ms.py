"""The cSPADE engine's construction a mine, in ms: the wall of its
``cspade.engine`` span, the item store's scatter build (``store.build``)
and the state pool's zero-fill (``cspade.pool``) inside it
(``fsmbench/spans.py``).  Host time: the device runs the fill after."""

from fsmbench import spans

SITES = ("cspade.engine",)


def install(rec):
    return spans.install(rec)


def read(rec):
    return spans.ms_per_mine(rec, SITES)
