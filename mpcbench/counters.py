"""Counters of the program that more than one metric reads.

The controllers' per-lane ``_last_iters`` and the per-instance ADMM's
``admm_solve_each.trace``, read by name; nothing here changes what the
program computes.
"""

from __future__ import annotations

import torch


def mean_iters(iters_by_step):
    """Mean of per-lane iteration counts kept step by step."""
    if not iters_by_step:
        return None
    return float(torch.cat([it.reshape(-1) for it in iters_by_step]).double().mean())


def inner_trace_open(run):
    """Start collecting each inner solve's (iterations, status) (once for all
    the readers of one run)."""
    from libmpc_tpu_torch.ops import admm

    if "inner_trace" not in run.shared:
        admm.admm_solve_each.trace = run.shared["inner_trace"] = []
    return None


def inner_trace_close(run):
    """The inner solves' iteration counts of the window, one tensor, and the
    collection stopped."""
    from libmpc_tpu_torch.ops import admm

    if "inner_iters" not in run.shared:
        admm.admm_solve_each.trace = None
        trace = run.shared.get("inner_trace") or []
        run.shared["inner_iters"] = (torch.cat([it.reshape(-1) for it, _ in trace])
                                     if trace else torch.zeros(0))
    return run.shared["inner_iters"]
