"""Share of the per-instance inner solves of the traced window that stopped
at the iteration cap (the configuration's ``inner_admm_cap``), from
``ops/admm.py::admm_solve_each.trace``."""

from mpcbench import counters


def open(run):
    return counters.inner_trace_open(run)


def close(run, state):
    return counters.inner_trace_close(run)


def read(run, state=None):
    it = state
    if it is None or it.numel() == 0:
        return None
    return 100.0 * float((it >= run.cfg["inner_admm_cap"]).double().mean())
