"""Kernel B1's share of its roofline over the window, in %: the least time
of every launch (``records.pair_bound_ms`` from the launch's P, NI, S, W
and live item rows, which a wrapper around
``spark_fsm_tpu_torch.ops.pair_support.pair_supports`` records) over
``pair_support_kernel``'s device time in the trace.  Nothing is read
unless the trace holds exactly the launches the wrapper saw."""

from fsmbench.records import pair_bound_ms

KERNEL = "pair_support_kernel"


def install(rec):
    from spark_fsm_tpu_torch.ops import pair_support as PS

    orig = PS.pair_supports

    def recorded(pt, items, n_item_rows, n_words=1, n_live=None):
        before = recorded.launches
        out = orig(pt, items, n_item_rows, n_words, n_live)
        if recorded.launches > before:
            rec.launch("b1", (pt.shape[0], n_item_rows,
                              pt.shape[1] // n_words, n_words,
                              n_item_rows if n_live is None else n_live))
        return out

    # the kernel path counts its launches on the module's name, now this
    recorded.launches = orig.launches

    def undo():
        orig.launches = recorded.launches
        PS.pair_supports = orig

    PS.pair_supports = recorded
    return undo


def read(rec):
    shapes = rec.launches.get("b1", [])
    kernels = rec.device_intervals(KERNEL)
    if not shapes or len(shapes) != len(kernels):
        return None
    bound_ms = sum(pair_bound_ms(*s)[0] for s in shapes)
    device_ms = sum(e - s for s, e in kernels) / 1e6
    return 100.0 * bound_ms / device_ms
