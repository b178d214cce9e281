"""Mean ADMM iterations a lane-solve, from the LMPC controller's per-lane
``_last_iters`` over every step of the traced window."""

from mpcbench import counters


def read(run, state=None):
    return counters.mean_iters(run.window.iters)
