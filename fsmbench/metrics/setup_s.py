"""Set-up time: process start to the first timed mine (imports, the CUDA
context, the database from the seed, the warm-up mines)."""


def read(rec):
    return rec.setup_s
