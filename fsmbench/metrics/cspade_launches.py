"""The cSPADE engine's device-step launches a mine
(``stats["kernel_launches"]``)."""


def read(rec):
    return rec.stat_per_mine("kernel_launches")
