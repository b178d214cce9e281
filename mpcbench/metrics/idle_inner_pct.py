"""Share of the profiled sub-window in which the card was idle while the
host was inside the SQP's inner QP, the span ``libmpc.sqp.inner_qp`` (on the
UGV the per-instance ADMM, ``libmpc_tpu_torch/ops/admm.py::
admm_solve_each``), in %.  Exact intersections, as ``idle_admm_pct``
computes them.  A profile without the span reports nothing."""

from mpcbench.metrics.idle_admm_pct import percent

SPANS = ("libmpc.sqp.inner_qp",)


def read(run, state=None):
    return percent(run, SPANS)
