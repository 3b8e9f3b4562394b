"""The SPADE engine's device-step launches a mine
(``stats["kernel_launches"]``: B1 and the row materializations of the
classic engine, one B1 launch a wave of the queue engine)."""


def read(rec):
    return rec.stat_per_mine("kernel_launches")
