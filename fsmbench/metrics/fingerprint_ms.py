"""Wall of the engine cache's content fingerprint (``db_fingerprint``: the
native flatten and blake2b) a mine, in ms: a wrapper around
``spark_fsm_tpu_torch.service.devcache.db_fingerprint``."""


def install(rec):
    from spark_fsm_tpu_torch.service import devcache

    return rec.wrap(devcache, "db_fingerprint", "db_fingerprint")


def read(rec):
    return rec.span_ms_per_mine("db_fingerprint")
