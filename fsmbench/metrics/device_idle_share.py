"""The device's idle share of the traced window, in %: 1 - (union of the
profiler's device-activity intervals) / window."""


def read(rec):
    busy = rec.device_busy_s()
    if not busy:
        return None
    lo, hi = rec.window_ns
    return 100.0 * (1.0 - busy / ((hi - lo) / 1e9))
