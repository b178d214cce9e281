"""Batch-sharded fleet solvers.

Port of ``libmpc_tpu/parallel/fleet.py``: one controller configuration,
thousands of problem instances (initial states, references, disturbances)
solved in lockstep, the batch split over the ranks of a
``torch.distributed`` process group (:mod:`.mesh`).  Every rank passes the
whole fleet's arrays, as the JAX package's caller does; each solves its
contiguous slice with the wrapped controller's own solve and kernels, and
the only collectives are the statistics' ``all_reduce`` (SUM, MAX) and the
``all_gather`` that makes the returned :class:`~libmpc_tpu_torch.types.Result`
the whole fleet's on every rank (the distributed analog of the reference's
per-controller ``SolutionStats``, include/mpc/Profiler.hpp:88-120).

What a rank decides is its own, as in the JAX package's ``shard_map``
program: each shard's adaptive rho, termination and straggler compaction
see only its rows, and its warm start, hold-last-command and cold-restart
state stay on the rank.  The ``time_limit`` budget is the exception: every
rank records the slowest rank's step time and the fleet's largest
iteration count, so all ranks pick the same iteration budget, as the JAX
package's single budgeter does.
"""

from __future__ import annotations

import dataclasses
import time as _time

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_leaves, tree_map

from ..lmpc import controller as lmpc_controller
from ..lmpc import problem as lmpc_problem
from ..ops import _host
from ..types import Result, ResultStatus
from ..utils import deadline
from . import mesh as mesh_lib
from .mesh import Mesh

_BUCKETS = (ResultStatus.SUCCESS, ResultStatus.MAX_ITERATION,
            ResultStatus.INFEASIBLE, ResultStatus.ERROR, ResultStatus.UNKNOWN)


@dataclasses.dataclass(frozen=True)
class FleetStats:
    """Fleet-level solve statistics, aggregated over every rank."""

    n_total: int
    n_success: int
    n_max_iteration: int
    n_infeasible: int
    n_error: int
    # UNKNOWN covers the reference's residual statuses — notably LMPC
    # time-limit stops (OSQP_TIME_LIMIT_REACHED -> ResultStatus::UNKNOWN,
    # reference: include/mpc/LMPC/LOptimizer.hpp:406-407) — so the five
    # buckets always sum to n_total
    n_unknown: int
    mean_iterations: float
    max_iterations: int

    def __str__(self):
        pct = lambda n: 100.0 * float(n) / max(1, int(self.n_total))
        return (
            "Fleet stats:\n"
            f"  - instances: {int(self.n_total)}\n"
            f"  - SUCCESS: {pct(self.n_success):.2f}%\n"
            f"  - MAX_ITERATION: {pct(self.n_max_iteration):.2f}%\n"
            f"  - INFEASIBLE: {pct(self.n_infeasible):.2f}%\n"
            f"  - ERROR: {pct(self.n_error):.2f}%\n"
            f"  - UNKNOWN: {pct(self.n_unknown):.2f}%\n"
            f"  - iterations: mean {float(self.mean_iterations):.1f}, "
            f"max {int(self.max_iterations)}\n"
        )


def _local_stats(status, iters, mesh: Mesh, elapsed: float = 0.0):
    """This rank's statuses and iteration counts reduced over the ranks:
    one SUM of the counts (exact integers) and one MAX of (iterations,
    ``elapsed``).  Returns ``(FleetStats, slowest rank's elapsed)``."""
    status = status.reshape(-1)
    iters = iters.reshape(-1).to(torch.int64)
    sums = torch.stack(
        [torch.tensor(status.shape[0], device=status.device)]
        + [(status == int(s)).sum() for s in _BUCKETS]
        + [iters.sum().to(status.device)]
    ).to(torch.int64)
    maxes = torch.stack([iters.max().to(torch.float64),
                         torch.tensor(float(elapsed), dtype=torch.float64,
                                      device=iters.device)])
    sums = _host.values(mesh_lib.all_reduce(mesh, sums, dist.ReduceOp.SUM))
    it_max, elapsed_max = _host.values(mesh_lib.all_reduce(mesh, maxes, dist.ReduceOp.MAX))
    n, *counts, it_sum = sums
    stats = FleetStats(n, *counts, mean_iterations=it_sum / max(n, 1),
                       max_iterations=int(it_max))
    return stats, elapsed_max


def _gather_result(mesh: Mesh, result: Result) -> Result:
    """The whole fleet's result on every rank: the rows of every rank in
    rank order, one ``all_gather`` of the fields packed as float64 (exact
    for the commands and costs of either dtype and for the integer codes)."""
    if mesh.backend is None:
        return result
    cmd = result.cmd
    nu = cmd.shape[-1]
    packed = torch.cat(
        [cmd.to(torch.float64)]
        + [getattr(result, f)[:, None].to(torch.float64)
           for f in ("cost", "status", "solver_status", "is_feasible")],
        dim=1,
    )
    full = mesh_lib.all_gather_rows(mesh, packed)
    return Result(
        cmd=full[:, :nu].to(cmd.dtype),
        cost=full[:, nu].to(result.cost.dtype),
        status=full[:, nu + 1].to(torch.int32),
        solver_status=full[:, nu + 2].to(torch.int32),
        is_feasible=full[:, nu + 3] != 0,
    )


def _check_batched(name: str, leading: int, B: int) -> None:
    if leading != B:
        raise ValueError(f"{name} is batched over {leading} instances; optimize() got {B}")


def _check_device(controller, mesh: Mesh) -> None:
    if controller.device.type != mesh.device.type:
        raise ValueError(
            f"the controller solves on {controller.device} and the mesh places "
            f"this rank on {mesh.device}"
        )


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class LMPCFleet:
    """Batch-sharded linear MPC.

    Wraps a configured :class:`~libmpc_tpu_torch.lmpc.controller.LMPC` and
    solves a whole fleet per call, on every rank::

        init_distributed()                           # once per process
        fleet = LMPCFleet(controller, make_mesh())
        result, stats = fleet.optimize(x0_batch, u_batch)

    Per-instance references/disturbances may be supplied as batched arrays;
    unbatched controller settings are shared.  The batch size must divide
    evenly over the mesh's data axis.
    """

    def __init__(self, controller, mesh: Mesh):
        _check_device(controller, mesh)
        self.controller = controller
        self.mesh = mesh
        self.dims = controller.dims
        self._warm_x = None
        self._warm_y = None
        self._prev_cmd = None  # hold-last-command state, carried across steps
        self._budgeter = deadline.IterationBudgeter()
        self._budget_key = None
        self._last_iters = None  # this rank's ADMM iterations of the last step
        # leaf ranks of an unbatched problem record: a deeper leaf carries
        # the fleet batch (per-instance bounds)
        template = lmpc_problem.init_problem(self.dims, controller.dtype, "cpu")
        self._leaf_dim = {f.name: getattr(template, f.name).dim()
                          for f in dataclasses.fields(template)}

    def optimize(self, x0, last_u, y_ref=None, u_ref=None, du_ref=None,
                 u_meas=None):
        """Solve the fleet step; returns ``(Result, FleetStats)`` with every
        result field batched over the whole fleet."""
        c, dims = self.controller, self.dims
        B = len(x0)
        rows = self.mesh.rows(B)
        b = rows.stop - rows.start
        zeros = lambda *s: torch.zeros(s, dtype=c.dtype, device=c.device)
        take = lambda a: c._t(a[rows])

        # problem leaves and built bound vectors that carry the fleet batch
        prob = c._prob
        batched = {name: getattr(prob, name) for name, d in self._leaf_dim.items()
                   if getattr(prob, name).dim() > d}
        for name, leaf in batched.items():
            _check_batched(name, leaf.shape[0], B)
        built = c._ensure_built()
        if built[2].dim() > 1:  # lineq carries the fleet batch
            _check_batched("the bound vectors", built[2].shape[0], B)
            built = (built[0], built[1], built[2][rows], built[3][rows], built[4])
        if batched:
            prob = dataclasses.replace(prob, **{k: v[rows] for k, v in batched.items()})

        if y_ref is not None:
            y_ref = take(y_ref)
            u_ref = take(u_ref) if u_ref is not None else zeros(b, dims.ph, dims.nu)
            du_ref = take(du_ref) if du_ref is not None else zeros(b, dims.ph, dims.nu)
            u_meas = take(u_meas) if u_meas is not None else zeros(b, dims.ph, dims.ndu)
        else:
            y_ref, u_ref, du_ref, u_meas = c._y_ref, c._u_ref, c._du_ref, c._u_meas
        x0, last_u = take(x0), take(last_u)

        have_warm = (c._params.enable_warm_start and self._warm_x is not None
                     and self._warm_x.shape[0] == b)
        warm_x = self._warm_x if have_warm else zeros(b, dims.nz)
        warm_y = self._warm_y if have_warm else zeros(b, dims.m)
        # hold-last-command across fleet steps: a failing instance keeps its
        # previous command rather than snapping to zero, mirroring the
        # single-controller path (reference: LOptimizer.hpp:349-361)
        prev_cmd = (self._prev_cmd if self._prev_cmd is not None
                    and tuple(self._prev_cmd.shape) == (b, dims.nu)
                    else zeros(b, dims.nu))

        # time_limit -> iteration budget, calibrated on fleet solves
        if self._budget_key != B:
            self._budgeter.reset()
            self._budget_key = B
        iter_budget = self._budgeter.budget(c._params.time_limit)

        t0 = _time.monotonic()
        result, _seq, sol_x, sol_y, iters = lmpc_controller.solve_body(
            dims, c._params, prob, x0, last_u, y_ref, u_ref, du_ref, u_meas,
            warm_x, warm_y, have_warm, prev_cmd, iter_budget, built,
        )
        _sync(c.device)
        stats, elapsed = _local_stats(result.status, iters, self.mesh,
                                      _time.monotonic() - t0)
        self._budgeter.record(elapsed, stats.max_iterations)
        self._warm_x, self._warm_y = sol_x, sol_y
        self._prev_cmd = result.cmd
        self._last_iters = iters
        return _gather_result(self.mesh, result), stats


class NLMPCFleet:
    """Batch-sharded nonlinear MPC.

    Same pattern as :class:`LMPCFleet`: each rank runs its slice through the
    controller's batched SQP solve (``NLMPC._solve_batch``) and failure
    mapping (``NLMPC._pack_result``), with per-instance runtime parameters
    and bounds sliced for the rank when they are batched.
    """

    def __init__(self, controller, mesh: Mesh):
        _check_device(controller, mesh)
        self.controller = controller
        self.mesh = mesh
        self._opt_vector = None
        self._slack = None
        self._prev_cmd = None  # hold-last-command state, carried across steps
        self._prev_status = None  # per-lane cold_restart_on_failure state
        self._budgeter = deadline.IterationBudgeter()
        self._budget_key = None
        self._last_iters = None  # this rank's SQP iterations of the last step

    def optimize(self, x0, last_u):
        c = self.controller
        dims = c.dims
        B = len(x0)
        rows = self.mesh.rows(B)
        b = rows.stop - rows.start
        lb, ub, b_batched = c._bounds_args()
        if b_batched:
            _check_batched("the instance bounds", lb.shape[0], B)
            lb, ub = lb[rows], ub[rows]
        p, p_batched = c._runtime_params, c._runtime_params_batched
        if p_batched:
            for leaf in tree_leaves(p):
                _check_batched("a runtime parameter", leaf.shape[0], B)
            p = tree_map(lambda a: a[rows], p)
        x0, last_u = c._t(x0[rows]), c._t(last_u[rows])
        zeros = lambda *s: torch.zeros(s, dtype=c.dtype, device=c.device)

        use_prev = (c._params.enable_warm_start and self._opt_vector is not None
                    and self._opt_vector.shape[0] == b)
        z_prev = self._opt_vector if use_prev else zeros(b, dims.nz)
        slack0 = self._slack if use_prev and self._slack is not None else zeros(b)
        # hold-last-command across fleet steps (reference:
        # NLOptimizer.hpp:613-624 keeps the previous command on failure)
        prev_cmd = (self._prev_cmd if self._prev_cmd is not None
                    and tuple(self._prev_cmd.shape) == (b, dims.nu)
                    else zeros(b, dims.nu))

        if self._budget_key != B:
            self._budgeter.reset()
            self._budget_key = B
        iter_budget = self._budgeter.budget(c._params.time_limit)

        # per-lane warm flag: under cold_restart_on_failure, lanes whose
        # previous solve FAILED re-enter from the cold initial guess
        use_arr = torch.full((b,), bool(use_prev), dtype=torch.bool, device=c.device)
        if (use_prev and c._params.cold_restart_on_failure
                and self._prev_status is not None
                and tuple(self._prev_status.shape) == (b,)):
            use_arr = use_arr & (self._prev_status != int(ResultStatus.ERROR))

        t0 = _time.monotonic()
        sol, X, U, Y, slack, feas = c._solve_batch(
            z_prev, use_arr, x0, last_u, slack0, p, p_batched, lb, ub, iter_budget)
        result, _seq = c._pack_result(sol, X, U, Y, feas, prev_cmd)
        _sync(c.device)
        stats, elapsed = _local_stats(result.status, sol.iters, self.mesh,
                                      _time.monotonic() - t0)
        self._budgeter.record(elapsed, stats.max_iterations)
        self._opt_vector, self._slack = sol.z, slack
        self._prev_cmd = result.cmd
        self._prev_status = result.status
        self._last_iters = sol.iters
        return _gather_result(self.mesh, result), stats
