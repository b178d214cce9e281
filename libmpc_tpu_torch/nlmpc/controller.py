"""Nonlinear MPC controller front-end.

Port of ``libmpc_tpu/nlmpc/controller.py``.  API-parity shell over the
functional NLP core: setter surface and error semantics mirror ``mpc::NLMPC``
(reference: include/mpc/NLMPC.hpp:54-418); the solve path is [warm-start
shift -> batched SQP with exact autodiff derivatives -> sequence unpack],
replacing the reference's NLopt-SLSQP + finite-difference pipeline
(reference: include/mpc/NLMPC/NLOptimizer.hpp:412-638).

Batching: ``optimize`` accepts a leading batch axis on ``x0``/``last_u``; the
SQP (including its inner QPs) runs batch-first on the controller's device.
An unbatched call runs the same code on a batch of one.
"""

from __future__ import annotations

import dataclasses
import time as _time
from typing import Callable, Optional

import numpy as np
import torch
from torch.func import jacfwd, vmap
from torch.utils._pytree import tree_map

from ..dims import NLDims
from ..ops import _host, sqp, trajectory_kkt
from ..types import (
    HorizonSlice,
    NLParameters,
    OptSequence,
    Result,
    ResultStatus,
    default_dtype,
    resolve_device,
    zero_result,
    zero_sequence,
)
from ..utils import deadline
from ..utils.logger import Logger, LogLevel
from ..utils.profiler import Profiler, SolutionStats
from . import problem as nlp

_STATUS_TABLE = (
    (sqp.NLOPT_FAILURE, ResultStatus.ERROR),
    (sqp.NLOPT_ROUNDOFF_LIMITED, ResultStatus.ERROR),
    (sqp.NLOPT_SUCCESS, ResultStatus.SUCCESS),
    (sqp.NLOPT_STOPVAL_REACHED, ResultStatus.SUCCESS),
    (sqp.NLOPT_FTOL_REACHED, ResultStatus.SUCCESS),
    (sqp.NLOPT_XTOL_REACHED, ResultStatus.SUCCESS),
    (sqp.NLOPT_MAXEVAL_REACHED, ResultStatus.MAX_ITERATION),
    (sqp.NLOPT_MAXTIME_REACHED, ResultStatus.MAX_ITERATION),
)

_CHUNK = 4  # SQP iterations per full-batch chunk of the straggler compaction
_COMPACT_MIN_BATCH = 128


def _status_from_nlopt(code):
    """nlopt result -> ResultStatus
    (reference: include/mpc/NLMPC/NLOptimizer.hpp:729-750)."""
    out = torch.full(code.shape, int(ResultStatus.UNKNOWN), dtype=torch.int32,
                     device=code.device)
    for nl, rs in _STATUS_TABLE:
        out = torch.where(code == nl, int(rs), out)
    return out


class NLMPC:
    """Nonlinear MPC (reference: include/mpc/NLMPC.hpp:30)::

        controller = NLMPC(nx=2, nu=1, ny=2, ph=10, ch=5, ineq=11, eq=0,
                           dtype=torch.float32, device="cuda")

    The solves run on ``device``: the CUDA card unless the caller says
    otherwise (``device="cpu"`` runs on the CPU).  User model callables are
    per-instance torch functions, return-value style (like the reference's
    Python bindings, python/pybind_export.cpp:20-57)::

        controller.set_state_space_function(lambda x, u, k: dx)
        controller.set_objective_function(lambda X, Y, U, e: cost)
        controller.set_ineq_con_function(lambda X, Y, U, e: values)
        controller.set_eq_con_function(lambda X, U: values)
    """

    def __init__(self, nx, nu, ny, ph, ch, ineq, eq, dtype=None, device=None):
        self.dims = NLDims(nx, nu, ny, ph, ch, ineq, eq).validate()
        self.dtype = dtype or default_dtype()
        self.device = resolve_device(device)
        self._fns = nlp.NLFunctions()
        self._params = NLParameters()
        self._state_scaling = torch.ones((nx,), dtype=self.dtype, device=self.device)
        self._input_scaling = torch.ones((nu,), dtype=self.dtype, device=self.device)
        self._ineq_tol = 1e-10
        self._eq_tol = 1e-10
        nz = self.dims.nz
        self._lb = np.full(nz, -np.inf)
        self._ub = np.full(nz, np.inf)
        # the slack entry is pinned to zero under hard constraints
        # (reference: include/mpc/NLMPC/NLOptimizer.hpp:180-186); with soft
        # constraints it is released to [0, inf) — a deliberate fix of the
        # reference, which never un-pins it once set
        self._apply_slack_bounds()
        self._opt_vector: Optional[torch.Tensor] = None
        self._current_slack = 0.0
        self._first_iteration = True
        self._result = zero_result(nu, self.dtype, device=self.device)
        self._sequence = zero_sequence(nx, ny, nu, ph, self.dtype, device=self.device)
        self._profiler = Profiler()
        self._last_iters = None
        self._stats_mode = "sync"  # see set_stats_mode
        # time_limit support: measured-cost iteration budget
        # (reference: NLMPC.hpp:142-144 -> nlopt set_maxtime)
        self._budgeter = deadline.IterationBudgeter()
        self._budget_key = None
        self._runtime_params = ()  # per-solve parameter pytree of tensors
        self._runtime_params_batched = False
        self._instance_bounds = None  # optional (B, nz) lb/ub override pair
        self._bounds_key = self._bounds_dev = None  # the shared bounds on the device
        self._solves = 0  # optimize calls, shown beside the optimize span
        self._traj_plan = None, False  # (plan, probed?)

    def _t(self, a) -> torch.Tensor:
        """A tensor of the controller's dtype on its device."""
        if isinstance(a, torch.Tensor):
            return a.to(device=self.device, dtype=self.dtype)
        return torch.as_tensor(np.array(a, float), dtype=self.dtype,
                               device=self.device)

    # ------------------------------------------------------------------
    # configuration surface (parity with NLMPC.hpp setters)
    # ------------------------------------------------------------------
    def set_logger_level(self, level: LogLevel) -> bool:
        Logger.instance().set_level(level)
        return True

    def set_logger_prefix(self, prefix: str) -> bool:
        Logger.instance().set_prefix(prefix)
        return True

    def set_discretization_sampling_time(self, ts: float) -> bool:
        """Marks the model continuous-time with trapezoidal defects
        (reference: include/mpc/NLMPC.hpp:80-90)."""
        self._fns = dataclasses.replace(self._fns, continuous=True, ts=float(ts))
        self._invalidate()
        return True

    def set_optimizer_parameters(self, params: NLParameters) -> None:
        if not isinstance(params, NLParameters):
            raise TypeError("NLMPC expects NLParameters")
        self._params = params
        self._apply_slack_bounds()
        self._invalidate()

    def _apply_slack_bounds(self):
        if self._params.hard_constraints:
            self._lb[-1] = 0.0
            self._ub[-1] = 0.0
        else:
            self._lb[-1] = 0.0
            self._ub[-1] = np.inf

    def set_instance_bounds(self, state=None, input=None) -> bool:
        """Per-instance hard box bounds for batched solves.

        ``state``/``input`` are optional ``(min, max)`` pairs of batched
        time-major arrays: state ``(B, ph, nx)`` (bounds on the decision
        states x_1..x_ph), input ``(B, ch, nu)`` (bounds on the blocked
        moves).  Unspecified parts inherit the shared bounds.  Packing
        matches the reference's decision layout
        (NLOptimizer.hpp:346-404); call with no arguments to clear.
        """
        if state is None and input is None:
            self._instance_bounds = None
            self._invalidate()
            return True
        dims = self.dims
        # determine the batch size from whichever pair is given
        ref = state if state is not None else input
        B = np.asarray(ref[0]).shape[0]
        lb = np.broadcast_to(self._lb, (B, dims.nz)).copy()
        ub = np.broadcast_to(self._ub, (B, dims.nz)).copy()
        if state is not None:
            mn, mx = (np.asarray(v, float) for v in state)
            if mn.shape[1:] != (dims.ph, dims.nx):
                raise ValueError(f"state bounds must be (B, {dims.ph}, {dims.nx})")
            lb[:, : dims.ph * dims.nx] = mn.reshape(B, -1)
            ub[:, : dims.ph * dims.nx] = mx.reshape(B, -1)
        if input is not None:
            mn, mx = (np.asarray(v, float) for v in input)
            if mn.shape[1:] != (dims.ch, dims.nu):
                raise ValueError(f"input bounds must be (B, {dims.ch}, {dims.nu})")
            off = dims.ph * dims.nx
            lb[:, off : off + dims.ch * dims.nu] = mn.reshape(B, -1)
            ub[:, off : off + dims.ch * dims.nu] = mx.reshape(B, -1)
        self._instance_bounds = (self._t(lb), self._t(ub))
        self._invalidate()
        return True

    def set_runtime_params(self, params, batched: bool = False) -> None:
        """Set the runtime-parameter pytree of tensors passed to callbacks
        that declare a trailing ``p`` argument.

        With ``batched=True`` every leaf carries a leading batch axis matched
        to the batch of ``optimize`` — per-instance scenario data (e.g. each
        instance its own obstacle set)."""
        if batched != self._runtime_params_batched:
            self._invalidate()
        self._runtime_params = tree_map(self._t, params)
        self._runtime_params_batched = batched

    def set_input_scale(self, scaling) -> None:
        """(reference: include/mpc/NLMPC.hpp:108-115)."""
        self._input_scaling = self._t(scaling).reshape(self.dims.nu)
        self._invalidate()

    def set_state_scale(self, scaling) -> None:
        """(reference: include/mpc/NLMPC.hpp:123-130)."""
        self._state_scaling = self._t(scaling).reshape(self.dims.nx)
        self._invalidate()

    def set_objective_function(self, handle: Callable) -> bool:
        """(reference: include/mpc/NLMPC.hpp:139-153)."""
        self._fns = dataclasses.replace(
            self._fns, objective_fn=nlp.canonicalize(handle, 4)
        )
        self._invalidate()
        return True

    def set_state_space_function(self, handle: Callable, eq_tol: float = 1e-10) -> bool:
        """(reference: include/mpc/NLMPC.hpp:165-193)."""
        self._fns = dataclasses.replace(
            self._fns, state_fn=nlp.canonicalize(handle, 3)
        )
        self._defect_tol = eq_tol
        self._invalidate()
        return True

    def set_output_function(self, handle: Callable) -> bool:
        """(reference: include/mpc/NLMPC.hpp:202-215)."""
        self._fns = dataclasses.replace(
            self._fns, output_fn=nlp.canonicalize(handle, 3)
        )
        self._invalidate()
        return True

    def set_ineq_con_function(self, handle: Callable, tol: float = 1e-10) -> bool:
        """Refuses when the ineq count is zero
        (reference: include/mpc/NLMPC.hpp:228-248)."""
        if self.dims.ineq == 0:
            Logger.instance().error(
                "The number of inequality constraints is zero, you cannot "
                "define a custom callback for the inequality constraints"
            )
            return False
        self._fns = dataclasses.replace(
            self._fns, ineq_fn=nlp.canonicalize(handle, 4)
        )
        self._ineq_tol = tol
        self._invalidate()
        return True

    def set_eq_con_function(self, handle: Callable, tol: float = 1e-10) -> bool:
        """Refuses when the eq count is zero
        (reference: include/mpc/NLMPC.hpp:261-281)."""
        if self.dims.eq == 0:
            Logger.instance().error(
                "The number of equality constraints is zero, you cannot "
                "define a custom callback for the equality constraints"
            )
            return False
        self._fns = dataclasses.replace(
            self._fns, eq_fn=nlp.canonicalize(handle, 2)
        )
        self._eq_tol = tol
        self._invalidate()
        return True

    # -- bounds (decision-space, like NLOptimizer.hpp:346-404) -----------
    def set_state_bounds(self, x_min, x_max, slice: Optional[HorizonSlice] = None) -> bool:
        x_min = np.asarray(x_min, float)
        x_max = np.asarray(x_max, float)
        if x_min.ndim == 2 and slice is None:
            ok = True
            for i in range(self.dims.ph):
                ok &= self.set_state_bounds(x_min[:, i], x_max[:, i], HorizonSlice(i, i + 1))
            return ok
        slice = slice if slice is not None else HorizonSlice.all()
        if not (slice.is_unset or self.is_prediction_horizon_slice_valid(slice)):
            return False
        start = 0 if slice.start == -1 else slice.start
        end = self.dims.ph if slice.end == -1 else slice.end
        nx = self.dims.nx
        for i in range(start, end):
            self._lb[i * nx : (i + 1) * nx] = x_min
            self._ub[i * nx : (i + 1) * nx] = x_max
        self._invalidate()
        return True

    def set_input_bounds(self, u_min, u_max, slice: Optional[HorizonSlice] = None) -> bool:
        u_min = np.asarray(u_min, float)
        u_max = np.asarray(u_max, float)
        if u_min.ndim == 2 and slice is None:
            ok = True
            for i in range(self.dims.ch):
                ok &= self.set_input_bounds(u_min[:, i], u_max[:, i], HorizonSlice(i, i + 1))
            return ok
        slice = slice if slice is not None else HorizonSlice.all()
        if not (slice.is_unset or self.is_control_horizon_slice_valid(slice)):
            return False
        start = 0 if slice.start == -1 else slice.start
        end = self.dims.ch if slice.end == -1 else slice.end
        nu, off = self.dims.nu, self.dims.ph * self.dims.nx
        for i in range(start, end):
            self._lb[off + i * nu : off + (i + 1) * nu] = u_min
            self._ub[off + i * nu : off + (i + 1) * nu] = u_max
        self._invalidate()
        return True

    def set_output_bounds(self, y_min, y_max, slice: Optional[HorizonSlice] = None) -> bool:
        """Output bounds are not available for NLMPC
        (reference: include/mpc/NLMPC.hpp:342-350)."""
        raise RuntimeError("Output constraints cannot be set for this type of MPC")

    # ------------------------------------------------------------------
    # solve
    # ------------------------------------------------------------------
    def _invalidate(self):
        self._traj_plan = None, False  # (plan, probed?)
        self._budgeter.reset()  # new configuration -> new calibration

    def _get_traj_plan(self):
        """Probe-once cache of the trajectory-structure plan
        (``ops/trajectory_kkt.make_plan``): enables the banded inner-QP
        engine when the NLP's sparsity is verified stage-local.  Invalidated
        by every setter that can change the structure."""
        plan, probed = self._traj_plan
        if probed:
            return plan
        p = self._runtime_params
        if self._runtime_params_batched and p is not None:
            # probe with a single instance's parameters
            p = tree_map(lambda a: a[0], p)
        plan = trajectory_kkt.make_plan(
            self.dims, self._fns, self._state_scaling, self._input_scaling,
            self._params.hessian_reg, self.dtype, p=p,
        )
        self._traj_plan = plan, True
        return plan

    def _nlp_fns(self):
        """The NLP as per-instance functions ``fn(z, x0, p)`` for the SQP."""
        dims, fns = self.dims, self._fns
        ss, us = self._state_scaling, self._input_scaling
        if fns.state_fn is None or fns.objective_fn is None:
            raise RuntimeError(
                "NLMPC requires a state-space function and an objective "
                "function before optimize()"
            )
        f_fn = lambda z, x0, p: nlp.objective(dims, fns, ss, us, z, x0, p)
        ceq_parts = [lambda z, x0, p: nlp.state_defects(dims, fns, ss, us, z, x0, p)]
        if fns.eq_fn is not None:
            ceq_parts.append(lambda z, x0, p: nlp.user_eq(dims, fns, ss, us, z, x0, p))
        ceq_fn = lambda z, x0, p: torch.cat([part(z, x0, p) for part in ceq_parts])
        cin_fn = (
            (lambda z, x0, p: nlp.user_ineq(dims, fns, ss, us, z, x0, p))
            if fns.ineq_fn is not None
            else None
        )
        return f_fn, ceq_fn, cin_fn

    def _solve_batch(self, z_prev, use_prev, x0, u0, slack0, p, p_batched, lb, ub,
                     iter_budget=None, params: Optional[NLParameters] = None):
        """One batched solve (every tensor has the batch axis leading; ``lb``
        /``ub`` may be shared): warm-start repair, SQP, unwrap.  Returns
        (sqp solution, X, U, Y, slack, feasible) — the unit the controller
        and the rollouts share."""
        dims, fns = self.dims, self._fns
        ss, us = self._state_scaling, self._input_scaling
        params = params if params is not None else self._params
        f_fn, ceq_fn, cin_fn = self._nlp_fns()
        plan = self._get_traj_plan()
        p_dim = 0 if p_batched else None

        guess = nlp.initial_guess(dims, x0, u0, slack0, self.dtype)
        z = torch.where(use_prev[:, None], z_prev, guess)
        z = nlp.fix_bounds(z, lb, ub)
        z = nlp.shift_warm_start(dims, z)
        z = torch.cat([z[:, :-1], slack0[:, None]], dim=1)

        solve = lambda **kw: sqp.sqp_solve(
            f_fn, ceq_fn, cin_fn, z, lb, ub, params, iter_budget=iter_budget,
            fn_args=(x0, p), fn_in_dims=(0, p_dim), traj_plan=plan, **kw)
        B = x0.shape[0]
        max_it = params.maximum_iteration
        cap = max(_COMPACT_MIN_BATCH, (B // 4 // _COMPACT_MIN_BATCH) * _COMPACT_MIN_BATCH)
        if (params.compact_stragglers and B >= _COMPACT_MIN_BATCH
                and max_it > 2 * _CHUNK and cap < B):
            sol = self._solve_compacted(solve, f_fn, ceq_fn, cin_fn, z, x0, p, p_dim,
                                        lb, ub, params, iter_budget, cap, plan)
        else:
            sol = solve()

        with _host.span("libmpc.nlmpc.result"):
            X, U, slack = vmap(lambda zz, xx: nlp.unwrap(dims, zz, xx, ss, us))(sol.z, x0)
            Y = vmap(lambda a, b, pp: nlp.get_output(dims, fns, a, b, pp),
                     in_dims=(0, 0, p_dim))(X, U, p)
            feas = vmap(
                lambda zz, xx, pp: nlp.is_feasible(
                    dims, fns, ss, us, zz, xx, self._ineq_tol, self._eq_tol, pp),
                in_dims=(0, 0, p_dim))(sol.z, x0, p)
        return sol, X, U, Y, slack, feas

    def _solve_compacted(self, solve, f_fn, ceq_fn, cin_fn, z, x0, p, p_dim, lb, ub,
                         params, iter_budget, cap, plan):
        """Batched solve with straggler compaction: short full-batch chunks
        of the SQP loop until the unconverged count falls to ``cap``, then
        gather those lanes and finish only them (the slowest few no longer
        drag the whole batch through every SQP iteration — same per-lane
        iteration sequence either way)."""
        max_it = params.maximum_iteration
        carry = solve(it_hi=0, return_carry=True)
        hi = 0
        while hi < max_it and _host.values((carry.status == 0).sum()) > cap:
            hi += _CHUNK
            carry = solve(carry_in=carry, it_hi=hi, return_carry=True)
        left = (carry.status == 0) & (carry.it < max_it)
        if _host.flag(left.any()):
            # at this point every active lane beyond the first `cap` has
            # already exhausted maximum_iteration, so the gather covers all
            # lanes with work left
            idx = _host.nonzero(left)
            take = lambda a: a[idx]
            sub = sqp.sqp_solve(
                f_fn, ceq_fn, cin_fn, take(z),
                take(lb) if lb.dim() == 2 else lb,
                take(ub) if ub.dim() == 2 else ub,
                params, iter_budget=iter_budget,
                carry_in=sqp.Carry(*(take(a) for a in carry)),
                return_carry=True,
                fn_args=(take(x0), tree_map(take, p) if p_dim == 0 else p),
                fn_in_dims=(0, p_dim), traj_plan=plan)
            carry = sqp.Carry(*(a.index_copy(0, idx, b) for a, b in zip(carry, sub)))
        return solve(carry_in=carry, it_hi=0)

    def _pack_result(self, sol, X, U, Y, feas, prev_cmd):
        """Map raw SQP output to (Result, OptSequence) with the reference's
        failure semantics (NLOptimizer.hpp:613-624): keep the previous
        command, zero the sequences, cost=inf."""
        failed = (
            (sol.status == sqp.NLOPT_FAILURE)
            | (sol.status == sqp.NLOPT_ROUNDOFF_LIMITED)
            | ~torch.all(torch.isfinite(sol.z), dim=-1)
        )
        cmd = torch.where(failed[..., None], prev_cmd, U[..., 0, :])
        zero = failed[..., None, None]
        result = Result(
            cmd=cmd,
            cost=torch.where(failed, float("inf"), sol.obj),
            status=torch.where(
                failed, int(ResultStatus.ERROR), _status_from_nlopt(sol.status)
            ).to(torch.int32),
            solver_status=torch.where(failed, -1, sol.status).to(torch.int32),
            is_feasible=feas & ~failed,
        )
        seq = OptSequence(
            state=torch.where(zero, 0.0, X),
            output=torch.where(zero, 0.0, Y),
            input=torch.where(zero, 0.0, U),
        )
        return result, seq

    def _bounds_args(self):
        """(lb, ub, batched?) for the current configuration.  The shared
        bounds are copied to the device when their values change, not every
        call: a copy from the host waits for the stream."""
        if self._instance_bounds is not None:
            lb, ub = self._instance_bounds
            return lb, ub, True
        key = (self._lb.tobytes(), self._ub.tobytes())
        if self._bounds_key != key:
            self._bounds_dev = self._t(self._lb), self._t(self._ub)
            self._bounds_key = key
        return (*self._bounds_dev, False)

    def optimize(self, x0, last_u) -> Result:
        """Compute the optimal control action
        (reference: include/mpc/IMPC.hpp:149-166 + NLOptimizer.hpp:412-638).

        ``x0``/``last_u`` may carry one leading batch axis.
        """
        self._solves += 1
        with _host.span("libmpc.nlmpc.optimize", self._solves):
            return self._optimize(x0, last_u)

    def _optimize(self, x0, last_u) -> Result:
        x0 = self._t(x0)
        last_u = self._t(last_u)
        batch = tuple(x0.shape[:-1])
        if self._instance_bounds is not None:
            B = self._instance_bounds[0].shape[0]
            if batch != (B,):
                raise ValueError(
                    f"per-instance bounds are set for batch {B}; optimize() "
                    f"got batch shape {batch}"
                )
        lead = batch or (1,)  # an unbatched call is a batch of one

        use_prev = (
            not self._first_iteration
            and self._params.enable_warm_start
            and self._opt_vector is not None
            and tuple(self._opt_vector.shape[:-1]) == batch
        )
        # per-lane warm flag: under cold_restart_on_failure, lanes whose
        # previous solve FAILED re-enter from the cold initial guess (see
        # NLParameters.cold_restart_on_failure)
        use_arr = torch.full(lead, bool(use_prev), dtype=torch.bool, device=self.device)
        if (
            use_prev
            and self._params.cold_restart_on_failure
            and tuple(self._result.status.shape) == batch
        ):
            use_arr = use_arr & (
                self._result.status != int(ResultStatus.ERROR)
            ).reshape(lead)
        z_prev = (
            self._opt_vector.reshape(lead + (self.dims.nz,))
            if use_prev
            else torch.zeros(lead + (self.dims.nz,), dtype=self.dtype, device=self.device)
        )
        slack0 = self._t(self._current_slack).expand(batch).reshape(lead)
        prev_cmd = (
            self._result.cmd
            if tuple(self._result.cmd.shape[:-1]) == batch
            else torch.zeros(batch + (self.dims.nu,), dtype=self.dtype, device=self.device)
        ).reshape(lead + (self.dims.nu,))

        # time_limit -> iteration budget (measured per-iteration cost)
        if self._budget_key != batch:
            self._budgeter.reset()
            self._budget_key = batch
        iter_budget = self._budgeter.budget(self._params.time_limit)

        # DETAIL-level dump of constraint values and exact Jacobians at the
        # solve's entry point, mirroring the reference's per-evaluation dumps
        # (reference: include/mpc/NLMPC/Constraints.hpp:294-313, :333-353)
        if Logger.instance().level == LogLevel.DEEP and x0.dim() == 1:
            self._dump_constraint_details(x0, last_u)

        self._profiler.solution_start()
        t0 = _time.monotonic()
        lb, ub, _ = self._bounds_args()
        p, p_batched = self._runtime_params, self._runtime_params_batched
        if not batch and p_batched:
            raise ValueError("batched runtime parameters need a batched optimize()")
        sol, X, U, Y, slack, feas = self._solve_batch(
            z_prev, use_arr, x0.reshape(lead + (self.dims.nx,)),
            last_u.reshape(lead + (self.dims.nu,)), slack0, p, p_batched, lb, ub,
            iter_budget,
        )
        with _host.span("libmpc.nlmpc.result"):
            result, seq = self._pack_result(sol, X, U, Y, feas, prev_cmd)
        z_out, iters = sol.z, sol.iters
        if not batch:
            first = lambda a: a[0]
            result = Result(*(first(getattr(result, f.name))
                              for f in dataclasses.fields(Result)[:5]))
            seq = OptSequence(first(seq.state), first(seq.output), first(seq.input))
            z_out, slack, iters = z_out[0], slack[0], iters[0]
        # "sync" stats wait for the device (true per-solve latency in the
        # profiler); "lazy" stats return right after dispatch — see
        # set_stats_mode.  time_limit calibration and verbose summaries
        # require the sync path.
        sync = (
            self._stats_mode == "sync"
            or self._params.time_limit > 0
            or self._params.verbose
        )
        if sync:
            with _host.span("libmpc.nlmpc.result"):
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                elapsed = _time.monotonic() - t0
                iters_max, status_val = _host.values(torch.stack(
                    [iters.max().long(), result.status.max().long()]
                ))
                self._budgeter.record(elapsed, iters_max)
            # populate the host-side status message like the reference's
            # exception reporting (NLOptimizer.hpp:550-571)
            if status_val == int(ResultStatus.ERROR):
                result = dataclasses.replace(
                    result,
                    solver_status_msg=(
                        "Internal solver error: line search could not make "
                        "progress (roundoff limited)"
                    ),
                )
        self._opt_vector = z_out
        self._current_slack = slack
        self._first_iteration = False
        self._result, self._sequence = result, seq
        self._last_iters = iters
        if sync:
            self._profiler.solution_end(result, status_max=status_val)
        else:
            self._profiler.solution_end(result, lazy=True)
        if self._params.verbose:
            it = iters.detach().cpu().numpy().astype(float)
            Logger.instance().info(
                f"SQP iterations: mean {it.mean():.1f}, max {int(it.max())}"
            )
        return result

    def _dump_constraint_details(self, x0, last_u) -> None:
        """DETAIL dumps of defect/user-constraint values and their exact
        Jacobians at the cold-start point (reference wording:
        Constraints.hpp:294-313 for user ineq, :333-353 for state eq)."""
        dims, fns = self.dims, self._fns
        ss, us = self._state_scaling, self._input_scaling
        p = self._runtime_params
        z = nlp.initial_guess(dims, x0, last_u, 0.0, self.dtype)
        log = Logger.instance()
        fmt = lambda a: np.array2string(
            a.detach().cpu().numpy(), precision=10, threshold=200
        )
        defects = lambda zz: nlp.state_defects(dims, fns, ss, us, zz, x0, p)
        log.detail(f"State equality constraints value:\n{fmt(defects(z))}")
        log.detail(
            f"State equality constraints jacobian:\n{fmt(jacfwd(defects)(z))}"
        )
        if fns.ineq_fn is not None:
            ineq = lambda zz: nlp.user_ineq(dims, fns, ss, us, zz, x0, p)
            log.detail(f"User inequality constraints value:\n{fmt(ineq(z))}")
            log.detail(
                f"User inequality constraints jacobian:\n{fmt(jacfwd(ineq)(z))}"
            )
        if fns.eq_fn is not None:
            eq = lambda zz: nlp.user_eq(dims, fns, ss, us, zz, x0, p)
            log.detail(f"User equality constraints value:\n{fmt(eq(z))}")
            log.detail(
                f"User equality constraints jacobian:\n{fmt(jacfwd(eq)(z))}"
            )

    def get_last_result(self) -> Result:
        return self._result

    def get_optimal_sequence(self) -> OptSequence:
        return self._sequence

    def get_execution_stats(self) -> SolutionStats:
        return self._profiler.get_stats()

    def reset_stats(self) -> None:
        self._profiler.reset()

    def set_stats_mode(self, mode: str) -> None:
        """Per-solve stats synchronization policy.

        ``"sync"`` (default) waits for the device inside each ``optimize``
        so the profiler records true per-solve latency — matching the
        reference, whose solves are synchronous by nature.  ``"lazy"`` skips
        that wait: statuses are resolved in one batched transfer when stats
        are read, and the recorded times reflect host latency only (the SQP
        loop itself still reads one flag per iteration).  Ignored (forced
        sync) while ``time_limit`` or ``verbose`` are active.
        """
        if mode not in ("sync", "lazy"):
            raise ValueError(f"stats mode must be 'sync' or 'lazy', got {mode!r}")
        self._stats_mode = mode

    # -- checkpoint / resume ---------------------------------------------
    def save_state(self, path: str) -> None:
        """Snapshot warm-start state + last command to ``path`` (.npz, the
        JAX package's layout: either package loads the other's file)."""
        from ..utils import checkpoint

        checkpoint.save_nlmpc(self, path)

    def load_state(self, path: str) -> None:
        from ..utils import checkpoint

        checkpoint.load_nlmpc(self, path)

    # -- slice validation (reference: include/mpc/IMPC.hpp:244-283) -------
    def is_slice_unset(self, slice: HorizonSlice) -> bool:
        return slice.is_unset

    def is_prediction_horizon_slice_valid(self, slice: HorizonSlice) -> bool:
        return not (
            slice.start >= slice.end
            or slice.start > self.dims.ph
            or slice.end > self.dims.ph
        )

    def is_control_horizon_slice_valid(self, slice: HorizonSlice) -> bool:
        return not (
            slice.start >= slice.end
            or slice.start > self.dims.ch
            or slice.end > self.dims.ch
        )

    # -- test hooks ------------------------------------------------------
    def get_lower_bound(self) -> np.ndarray:
        """(reference: include/mpc/NLMPC/NLOptimizer.hpp:645-648)."""
        return self._lb.copy()

    def get_upper_bound(self) -> np.ndarray:
        """(reference: include/mpc/NLMPC/NLOptimizer.hpp:655-658)."""
        return self._ub.copy()
