"""1 - the union of the device's operations over the profiled window
(first ``perfbench.run`` span's start to the last one's end), in %."""


def read(rec):
    p = rec.profile
    if p is None or p.window_s <= 0:
        return None
    return 100.0 * (1.0 - p.busy_s / p.window_s)
