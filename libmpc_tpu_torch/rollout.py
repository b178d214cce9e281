"""Closed-loop rollouts.

Port of ``libmpc_tpu/rollout.py``.  The reference's application pattern is a
host loop (``r = controller.optimize(x, r.cmd); x = plant(x, r.cmd)`` —
examples/vanderpol_ex.cpp:76-85).  The JAX package compiles the whole closed
loop into one scanned device program; PyTorch runs eagerly, so here the loop
over control steps is a Python loop around the batched solve, with the warm
start carried between steps and every tensor staying on the controller's
device: an N-step, B-instance simulation for scenario studies, Monte-Carlo
evaluations and controller tuning sweeps.

The plant is any ``plant_fn(x, u, k) -> x_next`` on the (batched) state and
command tensors, ``k`` the integer step (use the controller's own model for
nominal rollouts, or a higher-fidelity / perturbed simulator for robustness
studies).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch
from torch.utils._pytree import tree_map

from .lmpc import controller as lmpc_mod
from .ops import _host, sqp
from .types import Result, ResultStatus
from .utils.logger import Logger


class Rollout(NamedTuple):
    """Closed-loop trajectories; leading batch axes follow the inputs."""

    states: torch.Tensor  # (..., n_steps+1, nx) — includes the initial state
    inputs: torch.Tensor  # (..., n_steps, nu) — applied commands
    costs: torch.Tensor  # (..., n_steps)
    statuses: torch.Tensor  # (..., n_steps) int32 ResultStatus values
    iterations: torch.Tensor  # (..., n_steps) solver iterations per step


def _pack(x_fin, steps, batch) -> Rollout:
    """Stack per-step records (x, cmd, cost, status, iters) along a time axis
    placed after the batch axes."""
    t = len(batch)
    xs, us, costs, sts, its = (torch.stack(col, dim=t) for col in zip(*steps))
    return Rollout(
        states=torch.cat([xs, x_fin[..., None, :]], dim=-2),
        inputs=us, costs=costs, statuses=sts, iterations=its,
    )


def lmpc_rollout(controller, plant_fn: Callable, x0, last_u, n_steps: int) -> Rollout:
    """Run ``n_steps`` closed-loop LMPC steps on the controller's device.

    ``x0``/``last_u`` may carry a leading batch axis; warm starting follows
    the controller's ``enable_warm_start`` parameter and is carried through
    the loop.  The time-invariant work (assembly, Ruiz, KKT inverse) is done
    once for the whole rollout; the controller's own warm start and last
    result are left untouched.
    """
    c = controller
    x = c._t(x0)
    u = c._t(last_u)
    batch = tuple(x.shape[:-1])
    built = c._ensure_built()
    wx = c._zeros(*batch, c.dims.nz)
    wy = c._zeros(*batch, c.dims.m)
    have_warm = False
    steps = []
    for k in range(n_steps):
        result, _seq, wx, wy, iters = lmpc_mod.solve_body(
            c.dims, c._params, c._prob, x, u, c._y_ref, c._u_ref, c._du_ref,
            c._u_meas, wx, wy, have_warm, u, None, built,
        )
        steps.append((x, result.cmd, result.cost, result.status, iters))
        x, u, have_warm = plant_fn(x, result.cmd, k), result.cmd, True
    return _pack(x, steps, batch)


def _rescue_setup(c, batch):
    """(rescue_k, rescue parameters) of the compacted two-phase rescue, or
    (0, None) when it is off.

    The rescue re-solves the failed lanes from the SAME entry state, so it
    only helps when its parameters change the solve — when the banded-KKT
    (riccati) engine is in use, whose ``inner_iters`` cap it deepens.  With
    any other engine it would be a deterministic repeat of the same failure,
    so it is disabled with a message instead of silently burning device
    time."""
    p = c._params
    if p.rescue_iters <= 0 or not batch:
        return 0, None
    dims = c.dims
    me = dims.ph * dims.nx + dims.eq
    try:
        engine = sqp.inner_engine(
            p, c.dtype, dims.nz, me + dims.ineq + dims.nz,
            sqp.plan_applies(c._get_traj_plan(), p, dims.nz, me, dims.ineq))
    except NotImplementedError:
        engine = None
    if engine != "riccati":
        Logger.instance().info(
            "rescue_iters > 0 has no effect with the current inner "
            "engine (it deepens the banded-KKT IPM cap only); "
            "rescue phase disabled for this rollout"
        )
        return 0, None
    B = batch[0]
    return min(B, max(16, B // 16)), dataclasses.replace(
        p, rescue_iters=0, inner_iters=p.rescue_iters,
        inner_iters_recovery=p.rescue_iters)


def nlmpc_rollout(controller, plant_fn: Callable, x0, last_u, n_steps: int,
                  params_fn: Callable = None, chunk_steps: int = 0) -> Rollout:
    """Run ``n_steps`` closed-loop NLMPC steps on the controller's device.

    The receding-horizon warm start (shifted previous solution + carried
    slack) is carried from step to step, exactly like the reference carries
    ``opt_vector`` across optimize calls (NLOptimizer.hpp:426-510); the
    controller's own warm start is left untouched.

    ``params_fn(x, k) -> p`` optionally recomputes the runtime-parameter
    pytree from the current (batched) plant state each step — the analog of
    the reference's host loop updating captured data before every optimize
    (e.g. the UGV example's renormalized velocity reference,
    examples/ugv_ex.cpp:143-151).  Its output must match the structure set
    via ``set_runtime_params`` (batched when the rollout is batched).

    ``chunk_steps`` splits the loop into runs of at most that many steps
    with a device synchronization between them (the per-instance solve
    sequence is identical).  The JAX package chains separately compiled
    device programs there; in this port it only bounds how far the host
    runs ahead of the device.

    With ``NLParameters.rescue_iters > 0`` and the banded-KKT engine in use
    (:func:`_rescue_setup`), a step whose fast solve left lanes in ERROR
    re-solves exactly those lanes, lowest index first and at most
    ``min(B, max(16, B // 16))`` of them, from the same entry state at the
    deep interior-point cap; a lane is replaced only where its rescue did
    not fail too, and its iteration count is the sum of both solves.  (The
    JAX package pads that gather to a fixed width with healthy lanes, which
    a host-driven loop does not need.)  ``nlmpc_rollout.rescued``, when a
    list, collects (failed lanes, rescued lanes) of each step.
    """
    c = controller
    dims = c.dims
    x = c._t(x0)
    u = c._t(last_u)
    batch = tuple(x.shape[:-1])
    lead = batch or (1,)
    rt = c._runtime_params
    p_batched = bool(c._runtime_params_batched or (params_fn is not None and batch))
    lb, ub, _ = c._bounds_args()
    chunk = n_steps if chunk_steps <= 0 else min(chunk_steps, n_steps)
    restart = c._params.cold_restart_on_failure
    rescue_k, rescue_params = _rescue_setup(c, batch)
    err_code = int(ResultStatus.ERROR)

    kw = dict(dtype=c.dtype, device=c.device)
    z = torch.zeros(lead + (dims.nz,), **kw)
    slack = torch.zeros(lead, **kw)
    hw = torch.zeros(lead, dtype=torch.bool, device=c.device)
    steps = []
    for k in range(n_steps):
        pk = params_fn(x, k) if params_fn is not None else rt
        xb, ub_ = x.reshape(lead + (dims.nx,)), u.reshape(lead + (dims.nu,))
        sol, X, U, Y, slack_n, feas = c._solve_batch(
            z, hw, xb, ub_, slack, pk, p_batched, lb, ub)
        result, _seq = c._pack_result(sol, X, U, Y, feas, ub_)
        z_out, iters = sol.z, sol.iters
        if rescue_k:
            failed = result.status == err_code
            n_rescued = 0
            if _host.flag(failed.any()):
                # exactly the failed lanes, lowest index first
                idx = _host.nonzero(failed)[:rescue_k]
                take = lambda a: a[idx]
                sol2, X2, U2, Y2, slack2, feas2 = c._solve_batch(
                    take(z), take(hw), take(xb), take(ub_), take(slack),
                    tree_map(take, pk) if p_batched else pk, p_batched,
                    take(lb) if lb.dim() == 2 else lb,
                    take(ub) if ub.dim() == 2 else ub, params=rescue_params)
                res2, _ = c._pack_result(sol2, X2, U2, Y2, feas2, take(ub_))
                # a rescue that also failed keeps the original
                # hold-last-command result
                good = res2.status != err_code

                def put(a, b):
                    g = good.reshape(good.shape + (1,) * (b.dim() - 1))
                    return a.index_copy(0, idx, torch.where(g, b, a[idx]))

                result = Result(
                    cmd=put(result.cmd, res2.cmd), cost=put(result.cost, res2.cost),
                    status=put(result.status, res2.status),
                    solver_status=put(result.solver_status, res2.solver_status),
                    is_feasible=put(result.is_feasible, res2.is_feasible))
                z_out = put(z_out, sol2.z)
                slack_n = put(slack_n, slack2)
                iters = put(iters, iters[idx] + sol2.iters)
                if nlmpc_rollout.rescued is not None:
                    n_rescued = _host.values(good.sum())
            if nlmpc_rollout.rescued is not None:
                nlmpc_rollout.rescued.append((_host.values(failed.sum()), n_rescued))
        z, slack = z_out, slack_n
        # per-lane warm flag: lets cold_restart_on_failure re-enter ONLY the
        # failed lanes from the cold initial guess next step
        hw = (result.status != err_code) if restart else torch.ones_like(hw)
        cmd = result.cmd.reshape(batch + (dims.nu,))
        steps.append((x, cmd, result.cost.reshape(batch), result.status.reshape(batch),
                      iters.reshape(batch)))
        x, u = plant_fn(x, cmd, k), cmd
        if (k + 1) % chunk == 0 and c.device.type == "cuda":
            torch.cuda.synchronize(c.device)
    return _pack(x, steps, batch)


nlmpc_rollout.rescued = None
