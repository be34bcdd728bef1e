"""Device: the share of the profiled slice, from its first device op to
its last, in which no op ran on the card, in %."""


def read(run):
    s = run.slice
    if not s or s["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
