"""Linear MPC controller front-end.

Port of ``libmpc_tpu/lmpc/controller.py``.  The setter surface (matrix,
per-slice, per-index forms; same error semantics) mirrors ``mpc::LMPC``
(reference: include/mpc/LMPC.hpp:51-722), while the solve path is one
batched function — assembly + batched ADMM + sequence unpack — instead of
the reference's per-step rebuild/osqp_setup/solve/teardown cycle
(reference: include/mpc/LMPC/LOptimizer.hpp:189-368).

Batching: ``optimize`` accepts an optional leading batch axis on
``x0``/``last_u`` (and per-instance bounds via ``set_instance_bounds``),
solving the whole fleet in one call on the controller's device.
"""

from __future__ import annotations

import dataclasses
import time as _time
from typing import Optional

import numpy as np
import torch

from ..dims import LDims
from ..ops import _host, admm
from ..types import (
    HorizonSlice,
    LParameters,
    OptSequence,
    Result,
    ResultStatus,
    default_dtype,
    resolve_device,
)
from ..utils import deadline
from ..utils.logger import Logger, LogLevel
from ..utils.profiler import Profiler, SolutionStats
from . import problem as qp

_STATUS_TABLE = (
    (admm.OSQP_SOLVED, ResultStatus.SUCCESS),
    (admm.OSQP_MAX_ITER_REACHED, ResultStatus.MAX_ITERATION),
    (admm.OSQP_PRIMAL_INFEASIBLE, ResultStatus.INFEASIBLE),
    (admm.OSQP_DUAL_INFEASIBLE, ResultStatus.INFEASIBLE),
    (admm.OSQP_SOLVED_INACCURATE, ResultStatus.SUCCESS),
    (admm.OSQP_PRIMAL_INFEASIBLE_INACCURATE, ResultStatus.SUCCESS),
    (admm.OSQP_DUAL_INFEASIBLE_INACCURATE, ResultStatus.SUCCESS),
    (admm.OSQP_TIME_LIMIT_REACHED, ResultStatus.UNKNOWN),
    (admm.OSQP_SIGINT, ResultStatus.ERROR),
    (admm.OSQP_NON_CVX, ResultStatus.ERROR),
)


def _status_from_osqp(code):
    """OSQP status -> ResultStatus (reference: include/mpc/LMPC/LOptimizer.hpp:386-415)."""
    out = torch.full(code.shape, int(ResultStatus.UNKNOWN), dtype=torch.int32,
                     device=code.device)
    for osqp_code, rs in _STATUS_TABLE:
        out = torch.where(code == osqp_code, int(rs), out)
    return out


def build_prepared(dims, params, prob, y_ref, u_ref, du_ref, u_meas):
    """Time-invariant solver state: QP matrices + scaling + KKT inverse.

    Computed once per configuration change and reused across control steps
    (OSQP's setup-once semantics; the cost scaling uses the q implied by the
    references *at preparation time*, exactly like osqp_setup followed by
    osqp_update_lin_cost keeps the setup-time scaling).
    """
    dev = prob.ssA.device
    admm.full_precision(dev)
    P, A, lineq, uineq = qp.build_time_invariant(dims, prob)
    eq_mask = torch.arange(dims.m, device=dev) < dims.n_eq
    loose_ineq = (lineq <= -admm.INF_BOUND) & (uineq >= admm.INF_BOUND)
    loose_ineq = torch.all(loose_ineq.reshape((-1, lineq.shape[-1])), dim=0)
    loose_mask = torch.cat(
        [torch.zeros((dims.n_eq,), dtype=torch.bool, device=dev), loose_ineq]
    )
    zeros = lambda k: torch.zeros((k,), dtype=P.dtype, device=dev)
    q, _, _ = qp.build_time_varying(
        dims, prob, lineq, uineq, zeros(dims.nx), zeros(dims.nu),
        y_ref, u_ref, du_ref, u_meas,
    )
    q_ref = torch.amax(torch.abs(q.reshape((-1, dims.nz))), dim=0)
    prep = admm.prepare_qp(P, A, q_ref, eq_mask, loose_mask, params)
    return P, A, lineq, uineq, prep


def solve_body(
    dims: LDims,
    params: LParameters,
    prob: qp.LProblemData,
    x0,
    u0,
    y_ref,
    u_ref,
    du_ref,
    u_meas,
    warm_x,
    warm_y,
    have_warm,
    prev_cmd,
    iter_budget=None,
    built=None,
):
    """One batched control-step solve: assemble QP -> ADMM -> unpack.

    ``built`` is the optional time-invariant cache from
    :func:`build_prepared` — (P, A, lineq, uineq, PreparedQP) — hoisting
    assembly + Ruiz + KKT factorization out of the hot path; when absent
    everything is rebuilt inline (the reference's per-step osqp_setup
    behavior, LOptimizer.hpp:261).
    """
    admm.full_precision(x0.device)
    return _solve_body_hp(
        dims, params, prob, x0, u0, y_ref, u_ref, du_ref, u_meas,
        warm_x, warm_y, have_warm, prev_cmd, iter_budget, built,
    )


def _solve_body_hp(
    dims, params, prob, x0, u0, y_ref, u_ref, du_ref, u_meas,
    warm_x, warm_y, have_warm, prev_cmd, iter_budget=None, built=None,
):
    if built is None:
        built = build_prepared(dims, params, prob, y_ref, u_ref, du_ref, u_meas)
    P, A, lineq, uineq, prep = built
    with _host.span("libmpc.lmpc.assemble"):
        q, l, u = qp.build_time_varying(
            dims, prob, lineq, uineq, x0, u0, y_ref, u_ref, du_ref, u_meas
        )
        use_warm = params.enable_warm_start
        if use_warm and params.warm_start_shift:
            warm_x, warm_y = qp.shift_warm_start(dims, warm_x, warm_y)
    # a fill, not a copy from the host: a copy would wait for the stream
    hw = torch.full((), bool(have_warm), device=x0.device)
    sol = admm.admm_solve(
        P, A, q, l, u,
        params=params,
        warm_x=torch.where(hw, warm_x, 0.0) if use_warm else None,
        warm_y=torch.where(hw, warm_y, 0.0) if use_warm else None,
        iter_budget=iter_budget,
        prepared=prep,
        # the flag (not just zeroed arrays) reaches the solver so the cold
        # path can take its seed (params.cold_start, params.cold_rho)
        have_warm=hw if use_warm else None,
    )

    with _host.span("libmpc.lmpc.result"):
        states, inputs, outputs = qp.unpack_solution(dims, prob, sol.x, u_meas)
        cmd = inputs[..., 0, :]

        status = _status_from_osqp(sol.status)
        is_feasible = (
            (sol.status == admm.OSQP_SOLVED)
            | (sol.status == admm.OSQP_SOLVED_INACCURATE)
            | (sol.status == admm.OSQP_MAX_ITER_REACHED)
        )

        # OSQP v0.6.3 stores NaN solutions on infeasibility (auxil.c
        # store_solution), which the reference forwards verbatim; reproduce that
        # while zeroing sequences on hard errors like LOptimizer.hpp:349-361.
        infeasible = (sol.status == admm.OSQP_PRIMAL_INFEASIBLE) | (
            sol.status == admm.OSQP_DUAL_INFEASIBLE
        )
        bad = ~torch.all(torch.isfinite(sol.x), dim=-1) & ~infeasible
        cmd = torch.where(infeasible[..., None], float("nan"), cmd)
        cmd = torch.where(bad[..., None], prev_cmd, cmd)
        zero_mask = bad[..., None, None]
        states = torch.where(zero_mask, 0.0, states)
        inputs = torch.where(zero_mask, 0.0, inputs)
        outputs = torch.where(zero_mask, 0.0, outputs)
        cost = torch.where(bad | infeasible, float("inf"), sol.obj_val)
        status = torch.where(bad, int(ResultStatus.ERROR), status)

        result = Result(
            cmd=cmd,
            cost=cost,
            status=status,
            solver_status=sol.status,
            is_feasible=is_feasible & ~bad,
        )
        seq = OptSequence(state=states, output=outputs, input=inputs)
    return result, seq, sol.x, sol.y, sol.iters


def _np(t) -> np.ndarray:
    """Host copy of a tensor as a writable float numpy array."""
    return t.detach().cpu().numpy().copy()


class LMPC:
    """Linear MPC (reference: include/mpc/LMPC.hpp:26).

    Construction takes the problem dimensions directly (the analog of both the
    reference's template and dynamic constructors), plus the working dtype
    and the device the solves run on (the CUDA card unless ``device`` says
    otherwise; ``device="cpu"`` runs on the CPU)::

        controller = LMPC(nx=12, nu=4, ndu=4, ny=12, ph=10, ch=10,
                          dtype=torch.float32, device="cuda")
    """

    def __init__(
        self,
        nx: int,
        nu: int,
        ndu: int,
        ny: int,
        ph: int,
        ch: int,
        dtype=None,
        device=None,
    ):
        self.dims = LDims(nx, nu, ndu, ny, ph, ch).validate()
        self.dtype = dtype or default_dtype()
        self.device = resolve_device(device)
        self._prob = qp.init_problem(self.dims, self.dtype, self.device)
        self._params = LParameters()
        # references / exogenous inputs, time-major (ph, feature)
        # (reference: include/mpc/LMPC/LOptimizer.hpp:71-79)
        self._y_ref = self._zeros(ph, ny)
        self._u_ref = self._zeros(ph, nu)
        self._du_ref = self._zeros(ph, nu)
        self._u_meas = self._zeros(ph, max(ndu, 0))
        # warm-start state (reference: include/mpc/LMPC/LOptimizer.hpp:372)
        self._warm_x: Optional[torch.Tensor] = None
        self._warm_y: Optional[torch.Tensor] = None
        self._result = Result(
            cmd=self._zeros(nu),
            cost=self._zeros(),
            status=torch.tensor(int(ResultStatus.UNKNOWN), dtype=torch.int32,
                                device=self.device),
            solver_status=torch.tensor(0, dtype=torch.int32, device=self.device),
            is_feasible=torch.tensor(False, device=self.device),
        )
        self._sequence = OptSequence(
            state=self._zeros(ph + 1, nx),
            output=self._zeros(ph + 1, ny),
            input=self._zeros(ph + 1, nu),
        )
        self._profiler = Profiler()
        self._last_iters = None
        self._solves = 0  # optimize calls, shown beside the optimize span
        self._stats_mode = "sync"  # see set_stats_mode
        # time_limit support: measured-cost iteration budget
        # (reference: Types.hpp:108-110 -> OSQP settings->time_limit)
        self._budgeter = deadline.IterationBudgeter()
        self._budget_key = None  # batch shape the calibration belongs to
        # time-invariant cache (P/A/bounds/scaling/KKT inverse), invalidated
        # whenever the problem record or parameters change
        self._built = None
        self._built_prob = None
        self._built_params = None

    def _zeros(self, *shape):
        return torch.zeros(shape, dtype=self.dtype, device=self.device)

    def _t(self, a) -> torch.Tensor:
        """A tensor of the controller's dtype on its device."""
        if isinstance(a, torch.Tensor):
            return a.to(device=self.device, dtype=self.dtype)
        return torch.as_tensor(np.asarray(a, float), dtype=self.dtype,
                               device=self.device)

    # ------------------------------------------------------------------
    # configuration surface (parity with LMPC.hpp setters)
    # ------------------------------------------------------------------
    def set_logger_level(self, level: LogLevel) -> bool:
        Logger.instance().set_level(level)
        return True

    def set_logger_prefix(self, prefix: str) -> bool:
        Logger.instance().set_prefix(prefix)
        return True

    def set_discretization_sampling_time(self, ts: float) -> bool:
        """(NOT AVAILABLE) (reference: include/mpc/LMPC.hpp:68-72)."""
        raise RuntimeError("Linear MPC supports only discrete time systems")

    def set_input_scale(self, scaling) -> None:
        """(NOT AVAILABLE) (reference: include/mpc/LMPC.hpp:88-91)."""
        raise RuntimeError("Linear MPC does not support input scaling")

    def set_state_scale(self, scaling) -> None:
        """(NOT AVAILABLE) (reference: include/mpc/LMPC.hpp:97-100)."""
        raise RuntimeError("Linear MPC does not support state scaling")

    def set_optimizer_parameters(self, params: LParameters) -> None:
        if not isinstance(params, LParameters):
            raise TypeError("LMPC expects LParameters")
        if params != self._params:
            self._budgeter.reset()  # new configuration -> new calibration
        self._params = params

    def set_state_space_model(self, A, B, C) -> bool:
        """x+ = A x + B u, y = C x (reference: include/mpc/LMPC.hpp:493-500)."""
        A, B, C = self._t(A), self._t(B), self._t(C)
        self._check_shape(A, (self.dims.nx, self.dims.nx), "A")
        self._check_shape(B, (self.dims.nx, self.dims.nu), "B")
        self._check_shape(C, (self.dims.ny, self.dims.nx), "C")
        ssA, ssB, ssC = qp.make_augmented_model(A, B, C)
        self._prob = dataclasses.replace(self._prob, ssA=ssA, ssB=ssB, ssC=ssC)
        return True

    def set_disturbances(self, Bd, Dd) -> bool:
        """Disturbance maps (reference: include/mpc/LMPC.hpp:518-525)."""
        Bd, Dd = self._t(Bd), self._t(Dd)
        self._check_shape(Bd, (self.dims.nx, self.dims.ndu), "Bd")
        self._check_shape(Dd, (self.dims.ny, self.dims.ndu), "Dd")
        ssBv, ssDv = qp.make_disturbance_model(Bd, Dd, self.dims.nu)
        self._prob = dataclasses.replace(self._prob, ssBv=ssBv, ssDv=ssDv)
        return True

    # -- objective weights ----------------------------------------------
    def set_objective_weights(
        self, o_weight, u_weight, du_weight, slice: Optional[HorizonSlice] = None
    ) -> bool:
        """Matrix form (feature, ph) or vector form + slice
        (reference: include/mpc/LMPC.hpp:306-481)."""
        o_weight = np.asarray(o_weight, float)
        if o_weight.ndim == 2 and slice is None:
            ow = o_weight.T  # -> (ph, ny)
            uw = np.asarray(u_weight, float).T
            dw = np.asarray(du_weight, float).T
            self._prob = dataclasses.replace(
                self._prob,
                w_out=self._t(_dup0(ow)),
                w_u=self._t(_dup0(uw)),
                w_du=self._t(dw),
            )
            return True

        slice = slice if slice is not None else HorizonSlice.all()
        ow = _np(self._prob.w_out)
        uw = _np(self._prob.w_u)
        dw = _np(self._prob.w_du)
        ok = self._foreach_ph_step(
            slice,
            lambda i: (
                _set_step(ow, i, o_weight),
                _set_step(uw, i, u_weight),
                dw.__setitem__(i, np.asarray(du_weight, float)),
            ),
        )
        if ok:
            self._prob = dataclasses.replace(
                self._prob, w_out=self._t(ow), w_u=self._t(uw), w_du=self._t(dw),
            )
        return ok

    # -- bounds ----------------------------------------------------------
    def set_state_bounds(self, x_min, x_max, slice: Optional[HorizonSlice] = None) -> bool:
        """(reference: include/mpc/LMPC.hpp:111-190)."""
        x_min = np.asarray(x_min, float)
        if x_min.ndim == 2 and slice is None:
            mn = _dup0(x_min.T)
            mx = _dup0(np.asarray(x_max, float).T)
            self._prob = dataclasses.replace(
                self._prob, min_x=self._t(mn), max_x=self._t(mx)
            )
            return True
        slice = slice if slice is not None else HorizonSlice.all()
        mn = _np(self._prob.min_x)
        mx = _np(self._prob.max_x)
        ok = self._foreach_ph_step(
            slice, lambda i: (_set_step(mn, i, x_min), _set_step(mx, i, x_max))
        )
        if ok:
            self._prob = dataclasses.replace(
                self._prob, min_x=self._t(mn), max_x=self._t(mx)
            )
        return ok

    def set_input_bounds(self, u_min, u_max, slice: Optional[HorizonSlice] = None) -> bool:
        """(reference: include/mpc/LMPC.hpp:124-242).  Bounds beyond the
        control horizon replicate the last control-horizon column
        (ProblemBuilder.hpp:397-413)."""
        u_min = np.asarray(u_min, float)
        if u_min.ndim == 2 and slice is None:
            mn = _np(self._prob.min_u)
            mx = _np(self._prob.max_u)
            umn = u_min.T  # (ch, nu)
            umx = np.asarray(u_max, float).T
            mn[: self.dims.ch] = umn
            mx[: self.dims.ch] = umx
            if self.dims.ch < self.dims.ph:
                mn[self.dims.ch :] = umn[-1]
                mx[self.dims.ch :] = umx[-1]
            self._prob = dataclasses.replace(
                self._prob, min_u=self._t(mn), max_u=self._t(mx)
            )
            return True
        slice = slice if slice is not None else HorizonSlice.all()
        if slice.is_unset:
            rep_min = np.tile(u_min, (self.dims.ch, 1))
            rep_max = np.tile(np.asarray(u_max, float), (self.dims.ch, 1))
            return self.set_input_bounds(rep_min.T, rep_max.T)
        if not self._is_ch_slice_valid(slice):
            return False
        mn = _np(self._prob.min_u)
        mx = _np(self._prob.max_u)
        for i in range(slice.start, slice.end):
            mn[i] = u_min
            mx[i] = np.asarray(u_max, float)
        self._prob = dataclasses.replace(
            self._prob, min_u=self._t(mn), max_u=self._t(mx)
        )
        return True

    def set_output_bounds(self, y_min, y_max, slice: Optional[HorizonSlice] = None) -> bool:
        """(reference: include/mpc/LMPC.hpp:137-292)."""
        y_min = np.asarray(y_min, float)
        if y_min.ndim == 2 and slice is None:
            mn = _dup0(y_min.T)
            mx = _dup0(np.asarray(y_max, float).T)
            self._prob = dataclasses.replace(
                self._prob, min_y=self._t(mn), max_y=self._t(mx)
            )
            return True
        slice = slice if slice is not None else HorizonSlice.all()
        mn = _np(self._prob.min_y)
        mx = _np(self._prob.max_y)
        ok = self._foreach_ph_step(
            slice, lambda i: (_set_step(mn, i, y_min), _set_step(mx, i, y_max))
        )
        if ok:
            self._prob = dataclasses.replace(
                self._prob, min_y=self._t(mn), max_y=self._t(mx)
            )
        return ok

    def set_constraints(self, index: int, x_min, u_min, y_min, x_max, u_max, y_max) -> bool:
        """Per-index combined box constraints (reference: include/mpc/LMPC.hpp:328-340)."""
        if index >= self.dims.ph:
            Logger.instance().error("Horizon index out of bounds")
            return False
        one = HorizonSlice(index, index + 1)
        ok = self.set_state_bounds(x_min, x_max, one)
        ok = self.set_output_bounds(y_min, y_max, one) and ok
        mn = _np(self._prob.min_u)
        mx = _np(self._prob.max_u)
        mn[index] = np.asarray(u_min, float)
        mx[index] = np.asarray(u_max, float)
        self._prob = dataclasses.replace(
            self._prob, min_u=self._t(mn), max_u=self._t(mx)
        )
        return ok

    def set_scalar_constraint(
        self, min_val, max_val, X, U, slice: Optional[HorizonSlice] = None,
        index: Optional[int] = None,
    ) -> bool:
        """min <= X'x + U'u <= max per step (reference: include/mpc/LMPC.hpp:355-422)."""
        s_mult = torch.cat([self._t(X).reshape(-1), self._t(U).reshape(-1)])
        s_min = _np(self._prob.s_min)
        s_max = _np(self._prob.s_max)
        if index is not None:
            if index >= self.dims.ph:
                Logger.instance().error("Horizon index out of bounds")
                return False
            s_min[index + 1] = min_val
            s_max[index + 1] = max_val
            if index == 0:
                s_min[0] = min_val
                s_max[0] = max_val
        else:
            slice = slice if slice is not None else HorizonSlice.all()
            if slice.is_unset:
                s_min[:] = min_val
                s_max[:] = max_val
            elif self._is_ph_slice_valid(slice):
                for i in range(slice.start, slice.end):
                    s_min[i + 1] = min_val
                    s_max[i + 1] = max_val
                    if i == 0:
                        s_min[0] = min_val
                        s_max[0] = max_val
            else:
                return False
        self._prob = dataclasses.replace(
            self._prob, s_min=self._t(s_min), s_max=self._t(s_max), s_mult=s_mult,
        )
        return True

    # -- references / exogenous -------------------------------------------
    def set_references(self, out_ref, cmd_ref, delta_cmd_ref,
                       slice: Optional[HorizonSlice] = None) -> bool:
        """(reference: include/mpc/LMPC.hpp:596-660)."""
        out_ref = np.asarray(out_ref, float)
        cmd_ref = np.asarray(cmd_ref, float)
        delta_cmd_ref = np.asarray(delta_cmd_ref, float)
        if out_ref.ndim == 2 and slice is None:
            self._y_ref = self._t(out_ref.T)
            self._u_ref = self._t(cmd_ref.T)
            self._du_ref = self._t(delta_cmd_ref.T)
            return True
        slice = slice if slice is not None else HorizonSlice.all()
        if slice.is_unset:
            reps = (self.dims.ph, 1)
            self._y_ref = self._t(np.tile(out_ref, reps))
            self._u_ref = self._t(np.tile(cmd_ref, reps))
            self._du_ref = self._t(np.tile(delta_cmd_ref, reps))
            return True
        if not self._is_ph_slice_valid(slice):
            return False
        y = _np(self._y_ref)
        uu = _np(self._u_ref)
        du = _np(self._du_ref)
        for i in range(slice.start, slice.end):
            y[i] = out_ref
            uu[i] = cmd_ref
            du[i] = delta_cmd_ref
        self._y_ref, self._u_ref, self._du_ref = self._t(y), self._t(uu), self._t(du)
        return True

    def set_exogenous_inputs(self, u_meas, slice: Optional[HorizonSlice] = None) -> bool:
        """(reference: include/mpc/LMPC.hpp:534-585)."""
        u_meas = np.asarray(u_meas, float)
        if u_meas.ndim == 2 and slice is None:
            self._u_meas = self._t(u_meas.T)
            return True
        slice = slice if slice is not None else HorizonSlice.all()
        if slice.is_unset:
            self._u_meas = self._t(np.tile(u_meas, (self.dims.ph, 1)))
            return True
        if not self._is_ch_slice_valid(slice):
            return False
        m = _np(self._u_meas)
        for i in range(slice.start, slice.end):
            m[i] = u_meas
        self._u_meas = self._t(m)
        return True

    # -- per-instance fleet bounds ------------------------------------------
    def set_instance_bounds(self, state=None, input=None, output=None,
                            scalar=None) -> bool:
        """Per-instance box bounds for batched solves.

        Each argument is an optional ``(min, max)`` pair of *batched,
        time-major* arrays: state/output ``(B, ph, nx/ny)``, input
        ``(B, ch, nu)``, scalar ``(B, ph)``.  Index-0 duplication and the
        ch->ph input replication follow the reference conventions.  The QP
        structure (model, weights) stays shared across the batch — only the
        bound vectors batch, so the solver's shared-KKT path is kept.
        """
        changes = {}
        if state is not None:
            mn, mx = (np.asarray(v, float) for v in state)
            changes["min_x"] = self._t(_dup_step0(mn))
            changes["max_x"] = self._t(_dup_step0(mx))
        if output is not None:
            mn, mx = (np.asarray(v, float) for v in output)
            changes["min_y"] = self._t(_dup_step0(mn))
            changes["max_y"] = self._t(_dup_step0(mx))
        if input is not None:
            mn, mx = (np.asarray(v, float) for v in input)
            ch, ph = self.dims.ch, self.dims.ph
            if mn.shape[-2] != ch:
                raise ValueError(f"input bounds must have {ch} steps")
            if ch < ph:
                rep = lambda a: np.concatenate(
                    [a, np.repeat(a[..., -1:, :], ph - ch, axis=-2)], axis=-2
                )
                mn, mx = rep(mn), rep(mx)
            changes["min_u"] = self._t(mn)
            changes["max_u"] = self._t(mx)
        if scalar is not None:
            mn, mx = (np.asarray(v, float) for v in scalar)
            changes["s_min"] = self._t(np.concatenate([mn[..., :1], mn], axis=-1))
            changes["s_max"] = self._t(np.concatenate([mx[..., :1], mx], axis=-1))
        if changes:
            self._prob = dataclasses.replace(self._prob, **changes)
        return True

    # -- warm start accessors (reference: include/mpc/LMPC.hpp:677-722) ---
    def get_solver_warm_start_primal(self):
        return _np(self._warm_x) if self._warm_x is not None else np.zeros((0,))

    def get_solver_warm_start_dual(self):
        return _np(self._warm_y) if self._warm_y is not None else np.zeros((0,))

    def set_solver_warm_start(self, warm_primal, warm_dual):
        self._warm_x = self._t(warm_primal)
        self._warm_y = self._t(warm_dual)

    # ------------------------------------------------------------------
    # solve
    # ------------------------------------------------------------------
    def optimize(self, x0, last_u) -> Result:
        """Compute the optimal control action
        (reference: include/mpc/IMPC.hpp:149-166).

        ``x0``/``last_u`` may carry a leading batch axis; the whole batch is
        solved in one call on the controller's device.
        """
        self._solves += 1
        with _host.span("libmpc.lmpc.optimize", self._solves):
            return self._optimize(x0, last_u)

    def _optimize(self, x0, last_u) -> Result:
        x0 = self._t(x0)
        last_u = self._t(last_u)
        batch = tuple(x0.shape[:-1])

        have_warm = (
            self._params.enable_warm_start
            and self._warm_x is not None
            and tuple(self._warm_x.shape[:-1]) == batch
        )
        warm_x = self._warm_x if have_warm else self._zeros(*batch, self.dims.nz)
        warm_y = self._warm_y if have_warm else self._zeros(*batch, self.dims.m)

        self._ensure_built()

        # DETAIL-level dump of the generated problem, mirroring the
        # reference's per-solve matrix logging (LOptimizer.hpp:201-211)
        log = Logger.instance()
        if log.level == LogLevel.DEEP:
            P, A, lineq, uineq, _prep = self._built
            qv, lv, uv = qp.build_time_varying(
                self.dims, self._prob, lineq, uineq, x0, last_u,
                self._y_ref, self._u_ref, self._du_ref, self._u_meas,
            )
            for name, arr in (("P", P), ("A", A), ("q", qv), ("l", lv), ("u", uv)):
                log.detail(f"{name} = {np.array2string(_np(arr), threshold=50)}")

        # time_limit -> iteration budget (measured per-iteration cost;
        # calibration restarts when the batch shape changes)
        if self._budget_key != batch:
            self._budgeter.reset()
            self._budget_key = batch
        iter_budget = self._budgeter.budget(self._params.time_limit)

        prev_cmd = (self._result.cmd if tuple(self._result.cmd.shape[:-1]) == batch
                    else self._zeros(*batch, self.dims.nu))
        self._profiler.solution_start()
        t0 = _time.monotonic()
        result, seq, sol_x, sol_y, iters = solve_body(
            self.dims, self._params, self._prob, x0, last_u,
            self._y_ref, self._u_ref, self._du_ref, self._u_meas,
            warm_x, warm_y, have_warm, prev_cmd, iter_budget, self._built,
        )
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
            with _host.span("libmpc.lmpc.result"):
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                elapsed = _time.monotonic() - t0
                iters_max, status_val = _host.values(torch.stack(
                    [iters.max().long(), result.status.max().long()]
                ))
                self._budgeter.record(elapsed, iters_max)
        self._warm_x, self._warm_y = sol_x, sol_y
        self._result, self._sequence = result, seq
        self._last_iters = iters
        if sync:
            self._profiler.solution_end(result, status_max=status_val)
        else:
            self._profiler.solution_end(result, lazy=True)
        if self._params.verbose:
            # the OSQP-verbose analog: per-solve iteration summary
            it = _np(iters).astype(float)
            Logger.instance().info(
                f"ADMM iterations: mean {it.mean():.1f}, max {int(it.max())}"
            )
        if log.level <= LogLevel.NORMAL:
            log.info(f"Optimization step completed, status: {_np(result.status)}")
        return result

    def _ensure_built(self):
        """Refresh the time-invariant cache (P/A/bounds/scaling/KKT inverse).

        Every setter replaces the problem record, so object identity is an
        exact cache key."""
        if self._built_prob is not self._prob or self._built_params != self._params:
            self._built = build_prepared(
                self.dims, self._params, self._prob,
                self._y_ref, self._u_ref, self._du_ref, self._u_meas,
            )
            self._built_prob = self._prob
            self._built_params = self._params
        return self._built

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
        reference, whose solves are synchronous by nature.  ``"lazy"``
        returns as soon as the solve is issued: statuses are resolved in one
        batched transfer when stats are read, and the recorded times reflect
        host latency only.  Ignored (forced sync) while ``time_limit`` or
        ``verbose`` are active.
        """
        if mode not in ("sync", "lazy"):
            raise ValueError(f"stats mode must be 'sync' or 'lazy', got {mode!r}")
        self._stats_mode = mode

    # -- checkpoint / resume ---------------------------------------------
    def save_state(self, path: str) -> None:
        """Snapshot warm-start state + last command to ``path`` (.npz, the
        JAX package's layout: either package loads the other's file)."""
        from ..utils import checkpoint

        checkpoint.save_lmpc(self, path)

    def load_state(self, path: str) -> None:
        from ..utils import checkpoint

        checkpoint.load_lmpc(self, path)

    # ------------------------------------------------------------------
    # slice validation (reference: include/mpc/IMPC.hpp:244-283)
    # ------------------------------------------------------------------
    def is_slice_unset(self, slice: HorizonSlice) -> bool:
        return slice.is_unset

    def is_prediction_horizon_slice_valid(self, slice: HorizonSlice) -> bool:
        if slice.start >= slice.end or slice.start > self.dims.ph or slice.end > self.dims.ph:
            return False
        return True

    def is_control_horizon_slice_valid(self, slice: HorizonSlice) -> bool:
        if slice.start >= slice.end or slice.start > self.dims.ch or slice.end > self.dims.ch:
            return False
        return True

    _is_ph_slice_valid = is_prediction_horizon_slice_valid
    _is_ch_slice_valid = is_control_horizon_slice_valid

    # ------------------------------------------------------------------
    def _foreach_ph_step(self, slice: HorizonSlice, fn) -> bool:
        if slice.is_unset:
            for i in range(self.dims.ph):
                fn(i)
            return True
        if not self._is_ph_slice_valid(slice):
            return False
        for i in range(slice.start, slice.end):
            fn(i)
        return True

    @staticmethod
    def _check_shape(arr, shape, name):
        if tuple(arr.shape) != tuple(shape):
            raise ValueError(f"{name} must have shape {shape}, got {tuple(arr.shape)}")


def _dup_step0(arr: np.ndarray) -> np.ndarray:
    """Batched time-major (…, ph, f) -> (…, ph+1, f) with the index-0
    duplication convention."""
    return np.concatenate([arr[..., :1, :], arr], axis=-2)


def _dup0(mat_ph: np.ndarray) -> np.ndarray:
    """(ph, f) -> (ph+1, f) with row 0 duplicating row 1's source (col-0
    duplication, reference: include/mpc/LMPC/ProblemBuilder.hpp:254-262)."""
    return np.concatenate([mat_ph[:1], mat_ph], axis=0)


def _set_step(arr_ph1: np.ndarray, i: int, value) -> None:
    """Write horizon step ``i`` into a (ph+1, f) array with index-0 duplication
    (reference: include/mpc/LMPC/ProblemBuilder.hpp:282-296)."""
    value = np.asarray(value, float)
    arr_ph1[i + 1] = value
    if i == 0:
        arr_ph1[0] = value
