"""Mean SQP iterations a lane-step, from the NLMPC controller's per-lane
``_last_iters`` over every step of the traced window."""

from mpcbench import counters


def read(run, state=None):
    return counters.mean_iters(run.window.iters)
