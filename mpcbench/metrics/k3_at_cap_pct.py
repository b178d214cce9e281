"""Share of the fused inner-QP instance-solves of the traced window that
reached the iteration cap (the configuration's ``k3_cap``), from
``ops/qp_inner_fused.py::solve_batched.trace`` (read as ``k3_iters_mean``
reads it)."""

from mpcbench.metrics import k3_iters_mean


def open(run):
    return k3_iters_mean.open(run)


def close(run, state=None):
    return k3_iters_mean.close(run, state)


def read(run, state=None):
    it = state
    if it is None or it.numel() == 0:
        return None
    return 100.0 * float((it >= run.cfg["k3_cap"]).double().mean())
