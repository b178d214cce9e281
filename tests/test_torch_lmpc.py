"""The slice as a whole: the port's LMPC controller against the goldens and
against the JAX package's controller on the same data."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import libmpc_tpu_torch as lt
from libmpc_tpu_torch import convert
from libmpc_tpu_torch.lmpc import controller as tctl
from libmpc_tpu_torch.lmpc import problem as tqp
from test_lmpc import make_quadrotor_controller, quadrotor_model

ROOT = Path(__file__).resolve().parent.parent
GOLDEN = np.load(ROOT / "tests" / "golden_trajectories.npz")
GOLDEN_CMD = np.array([-0.9916, 1.74839, -0.9916, 1.74839])


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def quadrotor(dtype=torch.float64, params=None):
    """tests/test_lmpc.py::make_quadrotor_controller, through the port's
    setters."""
    inf = lt.inf
    Ad, Bd, Cd = quadrotor_model()
    c = lt.LMPC(12, 4, 4, 12, 10, 10, dtype=dtype)
    assert c.set_state_space_model(Ad, Bd, Cd)
    assert c.set_disturbances(np.zeros((12, 4)), np.zeros((12, 4)))
    assert c.set_objective_weights(
        np.array([0, 0, 10, 10, 10, 10, 0, 0, 0, 5, 5, 5], float),
        np.full(4, 0.1), np.zeros(4), lt.HorizonSlice(0, 10))
    xmin = np.array([-np.pi / 6, -np.pi / 6, -inf, -inf, -inf, -1] + [-inf] * 6)
    xmax = np.array([np.pi / 6, np.pi / 6] + [inf] * 10)
    assert c.set_state_bounds(xmin, xmax, lt.HorizonSlice(0, 10))
    assert c.set_output_bounds(np.full(12, -inf), np.full(12, inf), lt.HorizonSlice(0, 10))
    u0 = 10.5916
    assert c.set_input_bounds(np.full(4, 9.6) - u0, np.full(4, 13.0) - u0,
                              lt.HorizonSlice(0, 10))
    assert c.set_references(np.zeros((12, 10)), np.zeros((4, 10)), np.zeros((4, 10)))
    y_ref = np.zeros(12)
    y_ref[2] = 1.0
    assert c.set_references(y_ref, np.zeros(4), np.zeros(4), lt.HorizonSlice(0, 10))
    c.set_optimizer_parameters(params or lt.LParameters(maximum_iteration=250))
    return c


def closed_loop_params():
    """bench.py:279-300."""
    return lt.LParameters(
        maximum_iteration=250, enable_warm_start=True, warm_start_shift=True,
        polish=True, polish_mode="shared", rho=0.01, cold_rho=0.1,
        check_termination=10,
    )


def test_quadrotor_20_step_golden_float64():
    c = quadrotor()
    Ad, Bd, _ = quadrotor_model()
    x, u = np.zeros(12), np.zeros(4)
    for k in range(20):
        res = c.optimize(x, u)
        u = res.cmd.numpy()
        assert np.allclose(u, GOLDEN["quadrotor_cmds"][k], atol=1e-6), k
        if k == 0:
            assert np.allclose(u, GOLDEN_CMD, atol=1e-4)
            assert int(res.status) == int(lt.ResultStatus.SUCCESS)
            assert bool(res.is_feasible)
        x = Ad @ x + Bd @ u
    assert c.get_optimal_sequence().input.shape == (11, 4)
    assert c.get_execution_stats().number_of_solutions == 20


def test_quadrotor_first_command_float32_bench_settings():
    c = quadrotor(torch.float32, closed_loop_params())
    res = c.optimize(np.zeros(12), np.zeros(4))
    assert res.cmd.dtype == torch.float32
    assert np.abs(res.cmd.numpy() - GOLDEN_CMD).max() <= 1e-4


def test_built_from_jax_problem_equals_setters():
    """The same controller twice: through the port's setters, and through
    ``convert.problem_from_numpy`` of the JAX controller's problem record.
    Both give identical P/A and commands."""
    jc = make_quadrotor_controller()
    arrays = {f.name: np.asarray(getattr(jc._prob, f.name))
              for f in dataclasses.fields(jc._prob)}
    a = quadrotor()
    b = quadrotor()
    b._prob = convert.problem_from_numpy(arrays)
    for t, u in zip(tqp.build_time_invariant(a.dims, a._prob)[:2],
                    tqp.build_time_invariant(b.dims, b._prob)[:2]):
        assert torch.equal(t, u)
    x0 = 0.05 * np.random.default_rng(0).normal(size=(3, 12))
    ra, rb = a.optimize(x0, np.zeros((3, 4))), b.optimize(x0, np.zeros((3, 4)))
    assert torch.equal(ra.cmd, rb.cmd)
    # and the JAX controller's prepared state feeds the port's solve
    jbuilt = jc._ensure_built()
    prep = convert.prepared_from_numpy(
        {k: None if v is None else np.asarray(v) for k, v in jbuilt[4]._asdict().items()})
    back = convert.prepared_to_numpy(prep)
    np.testing.assert_array_equal(back["M0"], np.asarray(jbuilt[4].M0))


def test_bench_closed_loop_matches_jax_float64():
    """bench.py's closed-loop settings at B=256 (straggler compaction runs),
    two steps in float64: per-lane status and iterations equal the JAX
    package's, commands to 1e-8."""
    from libmpc_tpu import LParameters as JParams

    B, K = 256, 2
    rng = np.random.default_rng(7)  # bench.py:268-276
    x = 0.05 * rng.normal(size=(B, 12))
    noise = 0.002 * rng.normal(size=(K, B, 12))
    jc = make_quadrotor_controller()
    jc.set_optimizer_parameters(JParams(**dataclasses.asdict(closed_loop_params())))
    tc = quadrotor(params=closed_loop_params())
    Ad, Bd, _ = quadrotor_model()
    xj, xt = x.copy(), x.copy()
    uj, ut = np.zeros((B, 4)), np.zeros((B, 4))
    for k in range(K):
        rj = jc.optimize(xj, uj)
        rt = tc.optimize(xt, ut)
        np.testing.assert_array_equal(rt.solver_status.numpy(), np.asarray(rj.solver_status))
        np.testing.assert_array_equal(rt.status.numpy(), np.asarray(rj.status))
        np.testing.assert_array_equal(tc._last_iters.numpy(), np.asarray(jc._last_iters))
        np.testing.assert_allclose(rt.cmd.numpy(), np.asarray(rj.cmd), rtol=0, atol=1e-8)
        uj, ut = np.asarray(rj.cmd), rt.cmd.numpy()
        xj = xj @ Ad.T + uj @ Bd.T + noise[k]
        xt = xt @ Ad.T + ut @ Bd.T + noise[k]
    assert int(tc._last_iters.max()) > 10  # a multi-block warm step


def test_infeasible_lane_reports_nan_and_others_solve():
    """Result mapping (lmpc/controller.py:160-195): a primal-infeasible lane
    reports NaN commands and INFEASIBLE; the other lanes are unaffected."""
    c = quadrotor(params=lt.LParameters(maximum_iteration=2000))
    B = 3
    ph = c.dims.ph
    lo = np.full((B, ph, 12), -np.inf)
    hi = np.full((B, ph, 12), np.inf)
    lo[1, :, 5], hi[1, :, 5] = 1.0, -1.0  # lane 1: empty box on state 5
    c.set_instance_bounds(state=(lo, hi))
    res = c.optimize(np.zeros((B, 12)), np.zeros((B, 4)))
    assert int(res.status[1]) == int(lt.ResultStatus.INFEASIBLE)
    assert torch.isnan(res.cmd[1]).all()
    assert (res.status[[0, 2]] == int(lt.ResultStatus.SUCCESS)).all()
    assert torch.isfinite(res.cmd[[0, 2]]).all()


def test_setter_contracts_and_warm_start_roundtrip():
    c = lt.LMPC(5, 3, 3, 7, 7, 5, dtype=torch.float64)
    with pytest.raises(RuntimeError):
        c.set_discretization_sampling_time(0.1)
    with pytest.raises(ValueError):
        c.set_state_space_model(np.eye(4), np.zeros((5, 3)), np.zeros((7, 5)))
    assert not c.set_input_bounds(np.zeros(3), np.ones(3), lt.HorizonSlice(0, 6))
    assert not c.set_constraints(7, *(np.zeros(k) for k in (5, 3, 7, 5, 3, 7)))
    assert c.is_prediction_horizon_slice_valid(lt.HorizonSlice(0, 7))
    assert not c.is_control_horizon_slice_valid(lt.HorizonSlice(2, 6))
    assert c.set_scalar_constraint(-1.0, 1.0, np.ones(5), np.ones(3), index=0)
    assert c._prob.s_min[0] == -1.0 and c._prob.s_min[1] == -1.0
    c.set_solver_warm_start(np.ones(c.dims.nz), np.zeros(c.dims.m))
    np.testing.assert_array_equal(c.get_solver_warm_start_primal(), np.ones(c.dims.nz))
    with pytest.raises(NotImplementedError):
        c.save_state("unused.npz")


def test_status_map_matches_reference_table():
    from libmpc_tpu_torch.ops import admm

    codes = torch.tensor([admm.OSQP_SOLVED, admm.OSQP_SOLVED_INACCURATE,
                          admm.OSQP_PRIMAL_INFEASIBLE_INACCURATE,
                          admm.OSQP_DUAL_INFEASIBLE_INACCURATE,
                          admm.OSQP_MAX_ITER_REACHED, admm.OSQP_PRIMAL_INFEASIBLE,
                          admm.OSQP_TIME_LIMIT_REACHED, admm.OSQP_NON_CVX, 99])
    RS = lt.ResultStatus
    want = [RS.SUCCESS] * 4 + [RS.MAX_ITERATION, RS.INFEASIBLE, RS.UNKNOWN,
                               RS.ERROR, RS.UNKNOWN]
    assert tctl._status_from_osqp(codes).tolist() == [int(w) for w in want]


def test_package_imports_neither_jax_nor_the_jax_package():
    code = ("import sys, libmpc_tpu_torch, libmpc_tpu_torch.convert; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'libmpc_tpu' or m.startswith('libmpc_tpu.')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    for path in (ROOT / "libmpc_tpu_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]):
                assert not (words[1] == "jax" or words[1].startswith("jax.")
                            or words[1].startswith("libmpc_tpu")
                            and not words[1].startswith("libmpc_tpu_torch")), (path, line)
