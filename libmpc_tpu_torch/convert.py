"""Carry the JAX package's data into the port and back, as numpy arrays.

The two packages compute the same things from the same data: a test builds
a controller in ``libmpc_tpu``, converts its problem record (``_prob``), its
prepared solver state (``_built``) or its warm start to numpy
(``{k: np.asarray(v)}``), and hands them to these functions to get the
port's tensors on a chosen device and dtype.  NLMPC state crosses the same
way: the warm start and bounds of a controller
(:func:`nlmpc_state_to_numpy` / :func:`nlmpc_state_from_numpy`, whose keys
are the attributes both packages' ``NLMPC`` share) and an SQP loop carry by
field name (:func:`carry_from_numpy` / :func:`carry_to_numpy`), so a test can
start both packages from the same state.  The banded-KKT engine's records
cross by field name too: a ``TrajPlan`` (:func:`traj_plan_from_fields`, from
any object with the plan's integer fields), ``TrajFactors`` and a
``TrajIPMSolution`` (batch axis leading).  Nothing here imports JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Tuple

import numpy as np
import torch

from .lmpc.problem import LProblemData
from .ops.admm import PreparedQP
from .ops.sqp import Carry
from .ops.trajectory_kkt import TrajFactors, TrajIPMSolution, TrajPlan


def _tensor(v, device, dtype):
    a = np.array(v)  # a writable copy (arrays read from JAX are read-only)
    if a.dtype == np.bool_:
        return torch.as_tensor(a, device=device)
    return torch.as_tensor(a, dtype=dtype, device=device)


def problem_from_numpy(arrays: Mapping[str, np.ndarray], device="cpu",
                       dtype=torch.float64) -> LProblemData:
    """An :class:`LProblemData` from numpy arrays named by its fields."""
    names = [f.name for f in dataclasses.fields(LProblemData)]
    missing = set(names) - set(arrays)
    if missing:
        raise KeyError(f"problem arrays missing {sorted(missing)}")
    return LProblemData(**{k: _tensor(arrays[k], device, dtype) for k in names})


def problem_to_numpy(prob: LProblemData) -> dict:
    return {f.name: getattr(prob, f.name).detach().cpu().numpy()
            for f in dataclasses.fields(LProblemData)}


def prepared_from_numpy(arrays: Mapping[str, Optional[np.ndarray]],
                        device="cpu", dtype=torch.float64) -> PreparedQP:
    """A :class:`PreparedQP` from numpy arrays named by its fields (the
    masks keep their bool dtype; ``Mpinv``/``Mpinv_lo`` may be None)."""
    return PreparedQP(**{
        k: None if arrays[k] is None else _tensor(arrays[k], device, dtype)
        for k in PreparedQP._fields
    })


def prepared_to_numpy(prep: PreparedQP) -> dict:
    return {k: None if v is None else v.detach().cpu().numpy()
            for k, v in prep._asdict().items()}


def warm_start_from_numpy(x, y, device="cpu",
                          dtype=torch.float64) -> Tuple[torch.Tensor, torch.Tensor]:
    return _tensor(x, device, dtype), _tensor(y, device, dtype)


def warm_start_to_numpy(x, y) -> Tuple[np.ndarray, np.ndarray]:
    return x.detach().cpu().numpy(), y.detach().cpu().numpy()


_CARRY_INT = ("it", "status", "ls_fails", "stall")


def carry_from_numpy(arrays: Mapping[str, np.ndarray], device="cpu",
                     dtype=torch.float64) -> Carry:
    """An SQP :class:`Carry` (batch axis leading) from numpy arrays named by
    its fields; counters become int32, flags stay bool."""
    out = {}
    for k in Carry._fields:
        a = np.array(arrays[k])
        if k in _CARRY_INT:
            out[k] = torch.as_tensor(a.astype(np.int32), device=device)
        else:
            out[k] = _tensor(a, device, dtype)
    return Carry(**out)


def carry_to_numpy(carry: Carry) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in carry._asdict().items()}


def traj_plan_from_fields(plan) -> Optional[TrajPlan]:
    """The port's :class:`TrajPlan` from any record with the same integer
    fields (the JAX package's plan, or a mapping); ``None`` stays ``None``."""
    if plan is None:
        return None
    get = plan.__getitem__ if isinstance(plan, Mapping) else lambda k: getattr(plan, k)
    return TrajPlan(**{f.name: int(get(f.name)) for f in dataclasses.fields(TrajPlan)})


def traj_factors_from_numpy(arrays: Mapping[str, np.ndarray], device="cpu",
                            dtype=torch.float64) -> TrajFactors:
    """:class:`TrajFactors` (batch axis leading) from numpy arrays named by
    its fields."""
    return TrajFactors(**{k: _tensor(arrays[k], device, dtype) for k in TrajFactors._fields})


def traj_ipm_solution_from_numpy(arrays: Mapping[str, np.ndarray], device="cpu",
                                 dtype=torch.float64) -> TrajIPMSolution:
    """A :class:`TrajIPMSolution` (batch axis leading) from numpy arrays named
    by its fields; ``status`` and ``iters`` become int32."""
    out = {}
    for k in TrajIPMSolution._fields:
        a = np.array(arrays[k])
        out[k] = (torch.as_tensor(a.astype(np.int32), device=device)
                  if k in ("status", "iters") else _tensor(a, device, dtype))
    return TrajIPMSolution(**out)


def nlmpc_state_to_numpy(controller) -> dict:
    """Warm start, last command and status, and bounds of an ``NLMPC`` (of
    either package: the attribute names are shared) as numpy arrays."""
    c = controller
    host = lambda v: None if v is None else (
        v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
    ib = c._instance_bounds
    return {
        "opt_vector": host(c._opt_vector),
        "current_slack": host(c._current_slack),
        "first_iteration": bool(c._first_iteration),
        "cmd": host(c._result.cmd),
        "status": host(c._result.status),
        "lb": np.array(c._lb, float),
        "ub": np.array(c._ub, float),
        "instance_lb": None if ib is None else host(ib[0]),
        "instance_ub": None if ib is None else host(ib[1]),
    }


def nlmpc_state_from_numpy(controller, state: Mapping) -> None:
    """Load :func:`nlmpc_state_to_numpy`'s record into the port's ``NLMPC``
    (tensors on the controller's device, in its dtype)."""
    c = controller
    t = lambda v: _tensor(v, c.device, c.dtype)
    c._opt_vector = None if state["opt_vector"] is None else t(state["opt_vector"])
    c._current_slack = t(state["current_slack"])
    c._first_iteration = bool(state["first_iteration"])
    c._result = dataclasses.replace(
        c._result, cmd=t(state["cmd"]),
        status=torch.as_tensor(np.array(state["status"]).astype(np.int32),
                               device=c.device))
    c._lb = np.array(state["lb"], float)
    c._ub = np.array(state["ub"], float)
    c._instance_bounds = (
        None if state["instance_lb"] is None
        else (t(state["instance_lb"]), t(state["instance_ub"])))
