"""``torch.cuda.max_memory_allocated()`` over the window (the peak is reset
at its start), in GiB; a store resident from set-up counts."""


def read(rec):
    if rec.memory_peak_bytes is None:
        return None
    return rec.memory_peak_bytes / float(1 << 30)
