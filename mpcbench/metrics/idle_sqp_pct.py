"""Share of the profiled sub-window in which the card was idle while the
host ran the SQP loop of ``libmpc_tpu_torch/ops/sqp.py`` outside its inner
QP: inside a ``libmpc.sqp.iteration`` or ``libmpc.sqp.loop_test`` span and
not inside ``libmpc.sqp.inner_qp``, in % (the derivatives, the second-order
correction, the line search and the loop tests).  Exact intersections, as
``idle_admm_pct`` computes them: with ``idle_inner_pct`` a part of
``device_idle_pct``.  A profile without these spans reports nothing."""

from mpcbench.metrics.idle_admm_pct import percent

SPANS = ("libmpc.sqp.iteration", "libmpc.sqp.loop_test")
INNER = ("libmpc.sqp.inner_qp",)


def read(run, state=None):
    return percent(run, SPANS, INNER)
