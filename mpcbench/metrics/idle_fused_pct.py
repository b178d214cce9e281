"""Share of the profiled sub-window in which the card was idle while the
host was inside the fused inner QP of ``libmpc_tpu_torch/ops/
qp_inner_fused.py``: its spans ``libmpc.qp_fused.scale`` (the host-side Ruiz
equilibration), ``.iterate`` (the K3 launch) and ``.unscale``, in %.  Exact
intersections, as ``idle_admm_pct`` computes them: a part of
``idle_inner_pct`` of the same profile.  A profile without these spans (a
program without them) reports nothing."""

from mpcbench.metrics.idle_admm_pct import percent

SPANS = ("libmpc.qp_fused.scale", "libmpc.qp_fused.iterate", "libmpc.qp_fused.unscale")


def read(run, state=None):
    return percent(run, SPANS)
