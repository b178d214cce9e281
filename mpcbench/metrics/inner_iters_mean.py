"""Mean ADMM iterations a per-instance inner solve, over every inner solve
of the traced window, from ``ops/admm.py::admm_solve_each.trace``."""

from mpcbench import counters


def open(run):
    return counters.inner_trace_open(run)


def close(run, state):
    return counters.inner_trace_close(run)


def read(run, state=None):
    it = state
    return None if it is None or it.numel() == 0 else float(it.double().mean())
