"""Measured-cost iteration budgets implementing the ``time_limit`` contract.

The reference hands ``Parameters::time_limit`` (seconds,
reference: include/mpc/Types.hpp:108-110) to its solvers, which consult a
wall clock inside their iteration loops (OSQP ``settings->time_limit``,
LOptimizer.hpp:256; nlopt ``set_maxtime``, NLMPC.hpp:142-144).  A solve
whose iterations run on the device does not read a wall clock between
them, so the contract is honored with a *measured-cost iteration budget*: the controller measures the
per-iteration wall cost of its own compiled solve and converts the deadline
into a traced iteration cap for the next solve.  Solvers stopped by the cap
report the reference's time-limit statuses (``OSQP_TIME_LIMIT_REACHED`` /
``NLOPT_MAXTIME_REACHED``) with the partial-but-valid iterate.

Calibration: the first call after a configuration change pays one-time
costs (kernel build and load, allocator warm-up), so it is never recorded; afterwards the estimate tracks the
*minimum* observed per-iteration cost (robust to host jitter — a too-large
estimate would stop solves too early).  Enforcement therefore begins at the
first solve after a measurement exists; earlier solves run unlimited.
"""

from __future__ import annotations

NO_BUDGET = 2**31 - 1


class IterationBudgeter:
    """Converts a wall-clock ``time_limit`` into a per-solve iteration cap."""

    def __init__(self):
        self._t_per_iter: float | None = None
        self._skip_next = True  # next record() is compile-polluted

    def reset(self) -> None:
        """Drop calibration (call when the compiled program changes:
        new shapes, new parameters, new problem structure)."""
        self._t_per_iter = None
        self._skip_next = True

    @property
    def seconds_per_iteration(self) -> float | None:
        return self._t_per_iter

    def budget(self, time_limit: float) -> int:
        """Iteration cap for a solve under ``time_limit`` seconds (<=0 or
        uncalibrated -> unlimited)."""
        if time_limit <= 0 or self._t_per_iter is None:
            return NO_BUDGET
        cap = time_limit / self._t_per_iter
        # clamp before int(): a generous deadline over a fast solve can
        # exceed int32 (callers stage the budget as an int32 device scalar)
        if cap >= NO_BUDGET:
            return NO_BUDGET
        return max(1, int(cap))

    def record(self, elapsed_s: float, iters_executed: int) -> None:
        """Feed one measured solve (wall seconds, iterations executed)."""
        if self._skip_next:
            self._skip_next = False
            return
        if iters_executed <= 0 or elapsed_s <= 0:
            return
        est = elapsed_s / iters_executed
        if self._t_per_iter is None or est < self._t_per_iter:
            self._t_per_iter = est
