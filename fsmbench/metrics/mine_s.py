"""The window's seconds over the mines completed in it."""


def read(rec):
    return rec.per_mine(rec.window_s)
