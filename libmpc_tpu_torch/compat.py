"""pympcxx compatibility layer.

Drop-in surface for scripts written against the reference's Python bindings
(reference: python/pybind_export.cpp): camelCase methods, mutable parameter
objects, the same constructor orders, enums and result fields.  Usage::

    import libmpc_tpu_torch.compat as mpc    # in place of `import pympcxx as mpc`

    controller = mpc.NLMPC(nx, nu, ny, ph, ch, ineq, eq)
    controller.setLoggerLevel(mpc.LoggerLevel.NORMAL)
    controller.setStateSpaceFunction(state_space, 1e-10)
    res = controller.optimize(x, u)
    print(res.cmd, res.cost)

Callbacks keep the binding's return-value convention
(pybind_export.cpp:20-57): ``state_space(x, u, k) -> dx``,
``cost(x, y, u, slack) -> value``, etc.  The controller differentiates them
with ``torch.func``, so they must be traceable by it:

* math on the arguments uses torch operations (``torch.stack``,
  ``torch.sum``, ...), not numpy;
* no ``.item()``, ``float()`` or numpy conversion of an argument;
* no in-place writes to an argument (build a new tensor instead);
* the horizon index ``k`` is a tensor, not a Python integer.

The constructors keep the pybind positional orders and take keyword-only
``dtype`` and ``device``, passed on to the port's controllers: the solves run
on the CUDA card unless ``device="cpu"`` is given.  Results are tensors on
the controller's device (call ``.cpu().numpy()`` to inspect them).
"""

from __future__ import annotations

from . import types as _t
from .lmpc.controller import LMPC as _LMPC
from .nlmpc.controller import NLMPC as _NLMPC
# Result/OptSequence are module-scope types in the reference binding
# (reference: python/pybind_export.cpp:173-178, 209-212)
from .types import HorizonSlice, OptSequence, Result, ResultStatus
from .utils.logger import LogLevel as LoggerLevel
from .utils.profiler import SolutionStats

__all__ = [
    "LMPC",
    "NLMPC",
    "Parameters",
    "LParameters",
    "NLParameters",
    "HorizonSlice",
    "LoggerLevel",
    "Result",
    "OptSequence",
    "ResultStatus",
    "SolutionStats",
    # export_values() puts enum members at module scope too
    "UNKNOWN", "SUCCESS", "MAX_ITERATION", "INFEASIBLE", "ERROR",
    "DEEP", "NORMAL", "ALERT", "NONE",
]

UNKNOWN = ResultStatus.UNKNOWN
SUCCESS = ResultStatus.SUCCESS
MAX_ITERATION = ResultStatus.MAX_ITERATION
INFEASIBLE = ResultStatus.INFEASIBLE
ERROR = ResultStatus.ERROR

DEEP = LoggerLevel.DEEP
NORMAL = LoggerLevel.NORMAL
ALERT = LoggerLevel.ALERT
NONE = LoggerLevel.NONE


class Parameters:
    """Mutable parameter object (the bindings expose field assignment,
    pybind_export.cpp:129-132)."""

    def __init__(self):
        d = _t.Parameters()
        self.maximum_iteration = d.maximum_iteration
        self.time_limit = d.time_limit
        self.enable_warm_start = d.enable_warm_start


class LParameters(Parameters):
    def __init__(self):
        super().__init__()
        d = _t.LParameters()
        for f in ("alpha", "rho", "eps_rel", "eps_abs", "eps_prim_inf",
                  "eps_dual_inf", "verbose", "adaptive_rho", "polish"):
            setattr(self, f, getattr(d, f))

    def _frozen(self) -> _t.LParameters:
        return _t.LParameters(
            maximum_iteration=int(self.maximum_iteration),
            time_limit=float(self.time_limit),
            enable_warm_start=bool(self.enable_warm_start),
            alpha=float(self.alpha),
            rho=float(self.rho),
            eps_rel=float(self.eps_rel),
            eps_abs=float(self.eps_abs),
            eps_prim_inf=float(self.eps_prim_inf),
            eps_dual_inf=float(self.eps_dual_inf),
            verbose=bool(self.verbose),
            adaptive_rho=bool(self.adaptive_rho),
            polish=bool(self.polish),
        )


class NLParameters(Parameters):
    def __init__(self):
        super().__init__()
        d = _t.NLParameters()
        for f in ("relative_ftol", "relative_xtol", "absolute_ftol",
                  "absolute_xtol", "hard_constraints"):
            setattr(self, f, getattr(d, f))

    def _frozen(self) -> _t.NLParameters:
        return _t.NLParameters(
            maximum_iteration=int(self.maximum_iteration),
            time_limit=float(self.time_limit),
            enable_warm_start=bool(self.enable_warm_start),
            relative_ftol=float(self.relative_ftol),
            relative_xtol=float(self.relative_xtol),
            absolute_ftol=float(self.absolute_ftol),
            absolute_xtol=float(self.absolute_xtol),
            hard_constraints=bool(self.hard_constraints),
        )


class _CamelBase:
    """Shared camelCase forwarding."""

    def setLoggerLevel(self, level):
        return self._c.set_logger_level(level)

    def setLoggerPrefix(self, prefix):
        return self._c.set_logger_prefix(prefix)

    def setOptimizerParameters(self, params):
        return self._c.set_optimizer_parameters(params._frozen())

    def optimize(self, x0, last_u):
        return self._c.optimize(x0, last_u)

    def getLastResult(self):
        return self._c.get_last_result()

    def getOptimalSequence(self):
        return self._c.get_optimal_sequence()

    def getExecutionStats(self):
        return self._c.get_execution_stats()

    def resetStats(self):
        return self._c.reset_stats()

    def setStateBounds(self, x_min, x_max, slice=None):
        return self._c.set_state_bounds(x_min, x_max, slice)

    def setInputBounds(self, u_min, u_max, slice=None):
        return self._c.set_input_bounds(u_min, u_max, slice)

    def setOutputBounds(self, y_min, y_max, slice=None):
        return self._c.set_output_bounds(y_min, y_max, slice)


class LMPC(_CamelBase):
    """pympcxx.LMPC(nx, nu, ndu, ny, ph, ch)."""

    def __init__(self, nx, nu, ndu, ny, ph, ch, *, dtype=None, device=None):
        self._c = _LMPC(nx, nu, ndu, ny, ph, ch, dtype=dtype, device=device)

    def setStateSpaceModel(self, A, B, C):
        return self._c.set_state_space_model(A, B, C)

    def setDisturbances(self, Bd, Dd):
        return self._c.set_disturbances(Bd, Dd)

    def setObjectiveWeights(self, ow, uw, duw, slice=None):
        return self._c.set_objective_weights(ow, uw, duw, slice)

    def setScalarConstraint(self, *args):
        # overloads: (index, min, max, X, U) or (min, max, X, U, slice)
        if isinstance(args[-1], HorizonSlice):
            min_v, max_v, X, U, slice = args
            return self._c.set_scalar_constraint(min_v, max_v, X, U, slice)
        index, min_v, max_v, X, U = args
        return self._c.set_scalar_constraint(min_v, max_v, X, U, index=index)

    def setExogenousInputs(self, u_meas, slice=None):
        return self._c.set_exogenous_inputs(u_meas, slice)

    def setReferences(self, out_ref, cmd_ref, delta_cmd_ref, slice=None):
        return self._c.set_references(out_ref, cmd_ref, delta_cmd_ref, slice)

    def getSolverWarmStartPrimal(self):
        return self._c.get_solver_warm_start_primal()

    def getSolverWarmStartDual(self):
        return self._c.get_solver_warm_start_dual()

    def setSolverWarmStart(self, primal, dual):
        return self._c.set_solver_warm_start(primal, dual)


class NLMPC(_CamelBase):
    """pympcxx.NLMPC(nx, nu, ny, ph, ch, ineq, eq)."""

    def __init__(self, nx, nu, ny, ph, ch, ineq, eq, *, dtype=None, device=None):
        self._c = _NLMPC(nx, nu, ny, ph, ch, ineq, eq, dtype=dtype, device=device)

    def setDiscretizationSamplingTime(self, ts):
        return self._c.set_discretization_sampling_time(ts)

    def setInputScale(self, scaling):
        return self._c.set_input_scale(scaling)

    def setStateScale(self, scaling):
        return self._c.set_state_scale(scaling)

    def setObjectiveFunction(self, handle):
        return self._c.set_objective_function(handle)

    def setStateSpaceFunction(self, handle, tol):
        return self._c.set_state_space_function(handle, tol)

    def setOutputFunction(self, handle):
        return self._c.set_output_function(handle)

    def setIneqConFunction(self, handle, tol):
        return self._c.set_ineq_con_function(handle, tol)

    def setEqConFunction(self, handle, tol):
        return self._c.set_eq_con_function(handle, tol)
