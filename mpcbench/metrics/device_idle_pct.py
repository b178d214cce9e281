"""Share of the profiled sub-window in which no operation ran on the card:
1 - the union of the device activities' intervals over the sub-window's
wall time (one H100, one stream)."""


def read(run, state=None):
    p = run.profile
    if p is None or p.window_s <= 0:
        return None
    return 100.0 * (1.0 - p.busy_s() / p.window_s)
