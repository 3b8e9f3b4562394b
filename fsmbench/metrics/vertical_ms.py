"""Wall of the host's vertical build a mine, in ms: a wrapper around
``build_vertical`` as ``models.spade_constrained`` imports it."""


def install(rec):
    from spark_fsm_tpu_torch.models import spade_constrained

    return rec.wrap(spade_constrained, "build_vertical", "build_vertical")


def read(rec):
    return rec.span_ms_per_mine("build_vertical")
