"""Port utilities against the JAX package's: discretization, RK4, logger,
profiler and the time-limit budgeter."""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libmpc_tpu.utils.discretization as jdisc
import libmpc_tpu.utils.integrators as jint
from libmpc_tpu_torch.types import Result, ResultStatus
from libmpc_tpu_torch.utils import deadline, discretization, integrators
from libmpc_tpu_torch.utils.logger import Logger, LogLevel
from libmpc_tpu_torch.utils.profiler import Profiler


def _system(seed=0, nx=4, nu=2, nd=1):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(nx, nx)), rng.normal(size=(nx, nu)),
            rng.normal(size=(nx, nd)))


def test_discretization_matches_jax():
    A, B, Be = _system()
    for got, want in zip(discretization.discretization(A, B, 0.1),
                         jdisc.discretization(jnp.asarray(A), jnp.asarray(B), 0.1)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-12)
    for got, want in zip(
        discretization.discretization_with_disturbance(A, B, Be, 0.05),
        jdisc.discretization_with_disturbance(jnp.asarray(A), jnp.asarray(B),
                                              jnp.asarray(Be), 0.05),
    ):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-12)
    Ad, Bd, Cd, Dd = discretization.discretization_with_output(
        A, B, np.eye(4), np.zeros((4, 2)), 0.1)
    assert Cd.shape == (4, 4) and Dd.shape == (4, 2)


def test_rk4_matches_jax():
    def f_t(x, u):
        return torch.stack([x[1], -torch.sin(x[0]) + u[0]])

    def f_j(x, u):
        return jnp.stack([x[1], -jnp.sin(x[0]) + u[0]])

    x0 = np.array([0.3, -0.1])
    u = np.array([0.2])
    got = integrators.rk4(f_t, torch.as_tensor(x0), torch.as_tensor(u), 0.01, 25)
    want = jint.rk4(f_j, jnp.asarray(x0), jnp.asarray(u), 0.01, 25)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-12)


def test_logger_levels_and_prefix():
    Logger._reset_for_tests()
    log = Logger.instance()
    buf = io.StringIO()
    log.set_stream(buf).set_prefix("quad").set_level(LogLevel.NORMAL)
    log.detail("hidden")
    log.info("shown")
    assert buf.getvalue() == "[MPC++ quad] shown\n"
    Logger._reset_for_tests()


def _result(status):
    s = torch.tensor(status, dtype=torch.int32)
    return Result(cmd=torch.zeros(1), cost=torch.zeros(()), status=s,
                  solver_status=s, is_feasible=torch.tensor(True))


def test_profiler_sync_and_lazy_counts():
    p = Profiler()
    for status in (0, 0, 2):
        p.solution_start()
        p.solution_end(_result(status))
    p.solution_start()
    p.solution_end(_result(1), lazy=True)
    stats = p.get_stats()
    assert stats.number_of_solutions == 4
    assert stats.solutions_states[ResultStatus.SUCCESS] == 2
    assert stats.solutions_states[ResultStatus.INFEASIBLE] == 1
    assert stats.solutions_states[ResultStatus.MAX_ITERATION] == 1


def test_budgeter_skips_first_record_and_tracks_minimum():
    b = deadline.IterationBudgeter()
    assert b.budget(0.01) == deadline.NO_BUDGET
    b.record(5.0, 10)  # first record: one-time costs, ignored
    assert b.budget(0.01) == deadline.NO_BUDGET
    b.record(0.02, 100)
    b.record(0.05, 100)
    assert b.seconds_per_iteration == pytest.approx(2e-4)
    assert b.budget(0.01) == 50
