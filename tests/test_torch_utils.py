"""Port utilities against the JAX package's: discretization, RK4, logger,
profiler, the time-limit budgeter and the FLOP/byte models."""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libmpc_tpu.utils.discretization as jdisc
import libmpc_tpu.utils.flops as jfl
import libmpc_tpu.utils.integrators as jint
from libmpc_tpu_torch.types import Result, ResultStatus
from libmpc_tpu_torch.utils import deadline, discretization, integrators
from libmpc_tpu_torch.utils import flops as fl
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


# (n, m): the quadrotor QP, Van der Pol's inner QP, the UGV's, a tiny one;
# (ph, ch, nx, nu, mi): the oscillators, Van der Pol, the UGV
QP_SHAPES = [(216, 535), (26, 57), (61, 123), (3, 5)]
TRAJ_SHAPES = [(20, 10, 12, 6, 126), (10, 5, 2, 1, 11), (10, 10, 4, 2, 22)]


@pytest.mark.parametrize("n,m", QP_SHAPES)
def test_admm_models_equal_jax(n, m):
    for refine in (True, False):
        assert fl.admm_iter_flops(n, m, refine) == jfl.admm_iter_flops(n, m, refine)
        assert fl.admm_xla_iter_bytes(n, m, refine) == jfl.admm_xla_iter_bytes(n, m, refine)
        for iters, every in ((20.0, 10), (3.0, 25), (250.0, 0)):
            assert (fl.admm_solve_flops(n, m, iters, every, refine)
                    == jfl.admm_solve_flops(n, m, iters, every, refine))
            for pallas in (True, False):
                assert (fl.admm_solve_bytes(n, m, iters, every, pallas, refine)
                        == jfl.admm_solve_bytes(n, m, iters, every, pallas, refine))
    for itemsize in (4, 8):
        assert (fl.admm_pallas_block_bytes(n, m, itemsize)
                == jfl.admm_pallas_block_bytes(n, m, itemsize))
        assert fl.admm_check_bytes(n, m, itemsize) == jfl.admm_check_bytes(n, m, itemsize)
    assert fl.admm_check_flops(n, m) == jfl.admm_check_flops(n, m)
    assert fl.fused_sqp_iter_flops(n, 20, 11) == jfl.fused_sqp_iter_flops(n, 20, 11)
    assert (fl.fused_sqp_iter_flops(n, 20, 11, admm_iters=300.0)
            == jfl.fused_sqp_iter_flops(n, 20, 11, admm_iters=300.0))


@pytest.mark.parametrize("ph,ch,nx,nu,mi", TRAJ_SHAPES)
def test_sqp_models_equal_jax(ph, ch, nx, nu, mi):
    assert (fl.traj_ipm_iter_flops(ph, ch, nx, nu, mi)
            == jfl.traj_ipm_iter_flops(ph, ch, nx, nu, mi))
    for ipm in (20.0, 45.0):
        assert (fl.sqp_iter_flops(ph, ch, nx, nu, mi, ipm)
                == jfl.sqp_iter_flops(ph, ch, nx, nu, mi, ipm))


def test_flop_models_positive_and_monotone():
    """tests/test_utils.py::TestRooflineModels' first structural check."""
    a = fl.admm_solve_flops(216, 535, 20.0, 10)
    b = fl.admm_solve_flops(216, 535, 40.0, 10)
    assert 0 < a < b
    s1 = fl.sqp_iter_flops(20, 10, 12, 6, 126)
    s2 = fl.sqp_iter_flops(20, 10, 12, 6, 126, ipm_iters=40.0)
    assert 0 < s1 < s2


def test_bytes_models():
    """tests/test_utils.py::TestRooflineModels' second: the fused block
    amortizes the iterations' traffic over the check window."""
    n, m = 216, 535
    blk = fl.admm_pallas_block_bytes(n, m)
    xla = fl.admm_xla_iter_bytes(n, m)
    assert blk / 10.0 < 0.25 * xla
    bp = fl.admm_solve_bytes(n, m, 20.0, 10, use_pallas=True)
    bx = fl.admm_solve_bytes(n, m, 20.0, 10, use_pallas=False)
    assert 0 < bp < bx
    assert fl.admm_check_bytes(n, m) > 0
