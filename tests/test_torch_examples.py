"""The UGV example configurations on the port against the JAX package
(tests/test_examples.py's UGV cases, at its small sizes, float64 on the
CPU); the oscillators' case and the surface's import boundary are in
tests/test_torch_examples_osc.py.

The UGV closed loop to the goal and the six ``examples/torch`` mains at full
width run on the card (``chip_smoke.py --phases surface``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libmpc_tpu_torch as lt
import test_examples as jex  # the JAX cases (module access: pytest collects no class twice)

CPU64 = dict(dtype=torch.float64, device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def ugv_controller(ph=6):
    """tests/test_examples.py::TestUGV.make_controller through the port."""
    n_obs = 2
    c = lt.NLMPC(4, 2, 4, ph, ph, (ph + 1) * n_obs, 0, **CPU64)
    A = np.zeros((4, 4))
    A[0:2, 2:4] = np.eye(2)
    B = np.zeros((4, 2))
    B[2:4, 0:2] = np.eye(2)
    Ad, Bd = lt.discretization(A, B, 0.1)
    c.set_state_space_function(lambda x, u, k: Ad @ x + Bd @ u)
    c.set_output_function(lambda x, u, k: x)

    obstacles = _t([[2.0, 1.0], [1.0, 1.0]])
    radii = _t([0.3, 0.3])

    def objective(X, Y, U, e, p):
        v_err = X[:, 2:4] - p["v_pref"][None, :]
        return 1e3 * torch.sum(v_err**2) + 1e-2 * torch.sum(U**2) + 1e-5 * e * e

    def ineq(X, Y, U, e):
        pos = X[:, 0:2]
        d = torch.sqrt(torch.sum((pos[:, None, :] - obstacles[None]) ** 2, -1))
        return (radii[None, :] - d).reshape(-1)

    c.set_objective_function(objective)
    c.set_ineq_con_function(ineq)
    c.set_runtime_params({"v_pref": torch.zeros(2)})
    c.set_optimizer_parameters(
        lt.NLParameters(maximum_iteration=60, hard_constraints=False, enable_warm_start=True))
    return c, Ad.numpy(), Bd.numpy()


def ugv_loop(c, Ad, Bd, steps, v_pref):
    """The TestUGV closed loop for ``steps`` steps: the commands and the
    statuses."""
    yref = np.array([2.0, 2.0])
    x, cmd, cmds, status = np.zeros(4), np.zeros(2), [], []
    for _ in range(steps):
        v = yref - x[:2]
        c.set_runtime_params({"v_pref": v_pref(v / max(np.linalg.norm(v), 1e-9))})
        res = c.optimize(x, cmd)
        cmd = np.asarray(res.cmd, dtype=float)
        cmds.append(cmd)
        status.append(int(res.status))
        x = Ad @ x + Bd @ cmd
    return np.array(cmds), np.array(status)


def test_ugv_closed_loop_matches_jax():
    """Ten steps of examples/ugv_ex.cpp's loop at ph=6, each package closing
    its own loop.  Until the first obstacle's constraint becomes active
    (steps 0-5) the commands agree to rounding.  At step 6 the two SQPs
    stop at points of one solution 7.9e-7 apart, inside their float64
    termination tolerance (stationarity 1e-7 of the iterate's scale,
    feasibility sqrt(1e-7) = 3.2e-4), and the loop carries that on (1.5e-4
    by step 9): every step stays within that feasibility tolerance."""
    c, Ad, Bd = ugv_controller()
    got, status = ugv_loop(c, Ad, Bd, 10, _t)
    jc, jAd, jBd, _, _ = jex.TestUGV().make_controller()
    want, jstatus = ugv_loop(jc, jAd, jBd, 10, jnp.asarray)
    err = np.abs(got - want).max(axis=1)
    assert err[:6].max() <= 1e-12
    assert err[6] <= 1e-6
    assert err.max() <= np.sqrt(1e-7)
    assert (status == 0).all() and (jstatus == 0).all()


def test_runtime_params_no_rebuild():
    """A value change of the runtime parameters keeps the controller's
    compiled state: the probed trajectory plan and the time-limit
    calibration (the JAX package's "no retrace")."""
    c, _, _ = ugv_controller()
    c.set_runtime_params({"v_pref": _t([1.0, 0.0])})
    c.optimize(np.zeros(4), np.zeros(2))
    plan, budgeter = c._traj_plan, c._budgeter
    assert plan[1]  # probed
    c.set_runtime_params({"v_pref": _t([0.0, 1.0])})
    c.optimize(np.zeros(4), np.zeros(2))
    assert c._traj_plan is plan and c._budgeter is budgeter


def test_runtime_params_change_affects_solution():
    c, _, _ = ugv_controller()
    c.set_runtime_params({"v_pref": _t([1.0, 0.0])})
    r1 = c.optimize(np.zeros(4), np.zeros(2))
    c2, _, _ = ugv_controller()
    c2.set_runtime_params({"v_pref": _t([0.0, 1.0])})
    r2 = c2.optimize(np.zeros(4), np.zeros(2))
    # accelerating toward +x vs +y gives different commands
    assert not np.allclose(r1.cmd.numpy(), r2.cmd.numpy(), atol=1e-3)


def test_batched_obstacle_sets():
    """Each instance avoids its own obstacle (batched runtime parameters)."""
    ph = 6
    c = lt.NLMPC(4, 2, 4, ph, ph, ph + 1, 0, **CPU64)
    A = np.zeros((4, 4))
    A[0:2, 2:4] = np.eye(2)
    B = np.zeros((4, 2))
    B[2:4, 0:2] = np.eye(2)
    Ad, Bd = lt.discretization(A, B, 0.1)
    c.set_state_space_function(lambda x, u, k: Ad @ x + Bd @ u)

    def objective(X, Y, U, e, p):
        v_err = X[:, 2:4] - _t([1.0, 0.0])[None, :]
        return 1e3 * torch.sum(v_err**2) + 1e-2 * torch.sum(U**2) + 1e-5 * e * e

    def ineq(X, Y, U, e, p):
        pos = X[:, 0:2]
        d = torch.sqrt(torch.sum((pos - p["obstacle"][None, :]) ** 2, -1))
        return 0.3 - d

    c.set_objective_function(objective)
    c.set_ineq_con_function(ineq)
    c.set_optimizer_parameters(lt.NLParameters(maximum_iteration=50, hard_constraints=False))
    Bn = 3
    obstacles = np.array([[0.6, 0.05], [0.6, -0.05], [10.0, 10.0]])
    c.set_runtime_params({"obstacle": obstacles}, batched=True)
    c.optimize(np.zeros((Bn, 4)), np.zeros((Bn, 2)))
    X = c.get_optimal_sequence().state.numpy()
    # instances with a near obstacle plan around it; the far-obstacle
    # instance drives straight: its planned y-deviation is the smallest
    dev = np.abs(X[:, :, 1]).max(axis=1)
    assert dev[2] <= dev[0] + 1e-9 and dev[2] <= dev[1] + 1e-9
    for i in range(Bn):
        d = np.linalg.norm(X[i, :, 0:2] - obstacles[i], axis=1)
        assert d.min() > 0.3 - 0.06, (i, d.min())
