"""Mean K3 iterations an instance-solve, over every fused inner-QP solve of
the traced window, from the fused engine's counter
``libmpc_tpu_torch/ops/qp_inner_fused.py::solve_batched.trace`` (each
solve's per-instance iteration counts, whole check blocks of 25).

:func:`open` and :func:`close` are shared by ``k3_at_cap_pct`` and
``k3_roofline_pct``: the window's counts are collected once for all readers
of a run, and ``close`` arms the counter again for the profiled sub-window,
whose counts ``k3_roofline_pct`` reads."""

import torch


def _engine():
    from libmpc_tpu_torch.ops import qp_inner_fused

    return qp_inner_fused.solve_batched


def _iters(trace):
    return (torch.cat([it.reshape(-1) for it, _ in trace]).cpu() if trace
            else torch.zeros(0, dtype=torch.int32))


def open(run):
    if "k3_trace" not in run.shared:
        _engine().trace = run.shared["k3_trace"] = []
    return None


def close(run, state=None):
    """The window's per-instance iteration counts, one tensor; the counter
    armed again (a new list) for the profiled sub-window."""
    if "k3_iters" not in run.shared:
        run.shared["k3_iters"] = _iters(run.shared.get("k3_trace"))
        _engine().trace = run.shared["k3_profile_trace"] = []
    return run.shared["k3_iters"]


def profile_iters(run):
    """The profiled sub-window's per-instance iteration counts (None where
    nothing was armed), the counter stopped."""
    _engine().trace = None
    trace = run.shared.get("k3_profile_trace")
    return None if trace is None else _iters(trace)


def read(run, state=None):
    it = state
    return None if it is None or it.numel() == 0 else float(it.double().mean())
