"""Per-solve wall-clock statistics.

Mirrors ``SolutionStats``/``Profiler`` (reference: include/mpc/Profiler.hpp:
88-229): min/max/avg/std solve time with the same online update formulas, plus
per-status solve counts.  The timer wraps the *host-observed* latency of a
solve (on CUDA the caller synchronizes, ``torch.cuda.synchronize``, before
``solution_end`` so device execution is actually included).
"""

from __future__ import annotations

import math
import time
from typing import Dict

import torch

from ..types import Result, ResultStatus

# lazy-mode records pin live device scalars until get_stats(); flush
# opportunistically past this many so an unread profiler cannot leak
_PENDING_FLUSH = 4096


class SolutionStats:
    """Accumulated solve-time statistics (reference: include/mpc/Profiler.hpp:88-120)."""

    def __init__(self):
        self.clear()

    def clear(self):
        self.min_solution_time = float("inf")
        self.max_solution_time = float("-inf")
        self.average_solution_time = 0.0
        self.total_solution_time = 0.0
        self.standard_deviation = 0.0
        self.number_of_solutions = 0
        self.solutions_states: Dict[ResultStatus, int] = {}

    @staticmethod
    def result_status_to_string(status: ResultStatus) -> str:
        try:
            return ResultStatus(status).name
        except ValueError:
            return "INVALID"

    def __str__(self) -> str:
        lines = [
            "Solution stats:",
            f"  - min: {self.min_solution_time:.6f} s",
            f"  - max: {self.max_solution_time:.6f} s",
            f"  - avg: {self.average_solution_time:.6f} s",
            f"  - std: {self.standard_deviation:.6f} s",
        ]
        if self.solutions_states:
            lines.append("Solution status percentages:")
            for status, count in self.solutions_states.items():
                pct = 100.0 * count / self.number_of_solutions
                lines.append(
                    f"  - {self.result_status_to_string(status)}: {pct:.2f}%"
                )
        lines.append("Total time and number of solutions:")
        lines.append(f"  - tot: {self.total_solution_time:.6f} s")
        lines.append(f"  - num: {self.number_of_solutions}")
        return "\n".join(lines) + "\n"


class Profiler:
    """Wraps each optimize call (reference: include/mpc/Profiler.hpp:130-229).

    The std-dev update deliberately reproduces the reference's recurrence
    (including its integer-ratio quirk ``n // (n-1)`` at Profiler.hpp:224) so
    the stats parity tests agree bit-for-bit in spirit; we use the float ratio
    since the reference divides ints only because of C++ integer types, and
    its own test (test_profiler.cpp:100-125) checks against ~0.081 within a
    loose tolerance that both formulations satisfy.
    """

    def __init__(self):
        self._stats = SolutionStats()
        self._start = None
        # lazily-resolved records: (host_elapsed, device max-status scalar).
        # Deferring the status readback keeps optimize() asynchronous and
        # resolves all pending statuses in ONE stacked transfer when stats
        # are actually read.
        self._pending = []

    def reset(self):
        self._stats.clear()
        self._pending = []

    def solution_start(self):
        self._start = time.perf_counter()

    def solution_end(
        self, result: Result, lazy: bool = False, status_max=None
    ) -> float:
        start = time.perf_counter() if self._start is None else self._start
        elapsed = time.perf_counter() - start
        if lazy:
            # defer the status readback; elapsed here is the host-observed
            # dispatch latency (the caller did not synchronize)
            self._pending.append((elapsed, result.status.max()))
            self._start = None
            # each pending record pins a live device scalar: a control loop
            # that never reads its stats would otherwise grow this without
            # bound.  One amortized sync per _PENDING_FLUSH solves is noise.
            if len(self._pending) >= _PENDING_FLUSH:
                self._flush()
            return elapsed
        if status_max is not None:
            # caller already read the batch-max status back — reuse it
            # instead of paying a second device round trip
            status = ResultStatus(int(status_max))
        else:
            # a batched result is classified by the worst status in the batch
            status = ResultStatus(int(result.status.max()))
        self._stats.solutions_states[status] = (
            self._stats.solutions_states.get(status, 0) + 1
        )
        self._add_solution_time(elapsed)
        return elapsed

    def get_stats(self) -> SolutionStats:
        self._flush()
        return self._stats

    def _flush(self):
        """Resolve all lazily-recorded solves with a single device transfer."""
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        statuses = torch.stack([s for _, s in pending]).tolist()
        for (elapsed, _), status_val in zip(pending, statuses):
            status = ResultStatus(int(status_val))
            self._stats.solutions_states[status] = (
                self._stats.solutions_states.get(status, 0) + 1
            )
            self._add_solution_time(elapsed)

    def _add_solution_time(self, elapsed: float):
        s = self._stats
        s.total_solution_time += elapsed
        s.number_of_solutions += 1
        s.min_solution_time = min(s.min_solution_time, elapsed)
        s.max_solution_time = max(s.max_solution_time, elapsed)

        n = s.number_of_solutions
        s.average_solution_time = (elapsed + (n - 1) * s.average_solution_time) / n
        if n == 1:
            s.standard_deviation = 0.0
        else:
            residual = (n / (n - 1)) * (elapsed - s.average_solution_time) ** 2
            std_old = (n - 2) * s.standard_deviation**2
            s.standard_deviation = math.sqrt((std_old + residual) / (n - 1))
