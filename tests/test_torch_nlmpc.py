"""The NLMPC slice as a whole: the port's ``NLMPC`` controller against the
goldens and against the JAX package's controller on the same inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libmpc_tpu as lj
import libmpc_tpu_torch as lt
from libmpc_tpu_torch import convert
from libmpc_tpu_torch.nlmpc import controller as tctl
from libmpc_tpu_torch.ops import sqp as tsqp

GOLDEN = np.load(__file__.rsplit("/", 1)[0] + "/golden_trajectories.npz")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def tvdp(x, u, k):
    return torch.stack([(1.0 - x[1] * x[1]) * x[0] - x[1] + u[0], x[0]])


def jvdp(x, u, k):
    return jnp.stack([(1.0 - x[1] * x[1]) * x[0] - x[1] + u[0], x[0]])


def torch_vdp(dtype=torch.float64, ph=10, ch=5, **params):
    """examples/vanderpol_ex.cpp:9-65 through the port's setters."""
    c = lt.NLMPC(nx=2, nu=1, ny=2, ph=ph, ch=ch, ineq=ph + 1, eq=0, dtype=dtype,
                 device="cpu")
    assert c.set_discretization_sampling_time(0.1)
    c.set_optimizer_parameters(lt.NLParameters(**params))
    assert c.set_state_space_function(tvdp)
    assert c.set_objective_function(lambda X, Y, U, e: torch.sum(X**2) + torch.sum(U**2))
    assert c.set_ineq_con_function(lambda X, Y, U, e: U[:, 0] - 0.5)
    return c


def jax_vdp(dtype=jnp.float64, ph=10, ch=5, **params):
    c = lj.NLMPC(nx=2, nu=1, ny=2, ph=ph, ch=ch, ineq=ph + 1, eq=0, dtype=dtype)
    c.set_discretization_sampling_time(0.1)
    c.set_optimizer_parameters(lj.NLParameters(**params))
    c.set_state_space_function(jvdp)
    c.set_objective_function(lambda X, Y, U, e: jnp.sum(X**2) + jnp.sum(U**2))
    c.set_ineq_con_function(lambda X, Y, U, e: U[:, 0] - 0.5)
    return c


def vdp_inputs(B, K):
    """bench.py:437-441."""
    rng = np.random.default_rng(11)
    return rng.uniform(-1.0, 1.0, size=(B, 2)), 0.01 * rng.normal(size=(K, B, 2))


def plant_np(x, u, noise):
    f = np.stack([(1.0 - x[:, 1] ** 2) * x[:, 0] - x[:, 1] + u[:, 0], x[:, 0]], axis=1)
    return x + 0.1 * f + noise


def test_vdp_20_step_golden_float64():
    """tests/test_golden_trajectories.py::test_vdp_20_step_commands through
    the port: within 1e-6 of ``vdp_cmds`` (float64, so the default fused
    request runs the banded-KKT interior point)."""
    c = torch_vdp(maximum_iteration=100)
    x, u = np.array([0.0, 1.0]), np.zeros(1)
    for k in range(20):
        res = c.optimize(x, u)
        u = res.cmd.numpy()
        assert np.allclose(u, GOLDEN["vdp_cmds"][k], atol=1e-6), k
        assert u[0] <= 0.5 + 1e-6
        x = x + tvdp(torch.as_tensor(x), torch.as_tensor(u), 0).numpy() * 0.1
    assert res.cmd.shape == (1,) and res.status.shape == ()
    assert int(res.status) == int(lt.ResultStatus.SUCCESS) and bool(res.is_feasible)
    seq = c.get_optimal_sequence()
    assert seq.state.shape == (11, 2) and seq.input.shape == (11, 1)
    assert c.get_execution_stats().number_of_solutions == 20


def test_closed_loop_matches_jax_float64():
    """A 5-step batched Van der Pol loop with the bench's settings in
    float64 (the fused request runs the banded-KKT interior point in both
    packages, the probe having verified the structure): per-lane statuses and SQP
    iteration counts equal the JAX package's, commands, costs and sequences
    within 1e-9."""
    B, K = 6, 5
    kw = dict(maximum_iteration=30, enable_warm_start=True, inner_qp="fused",
              hessian_reg="gershgorin")
    jc, tc = jax_vdp(**kw), torch_vdp(**kw)
    x, noise = vdp_inputs(B, K)
    xj, xt = x.copy(), x.copy()
    uj, ut = np.zeros((B, 1)), np.zeros((B, 1))
    for k in range(K):
        rj, rt = jc.optimize(xj, uj), tc.optimize(xt, ut)
        np.testing.assert_array_equal(rt.solver_status.numpy(), np.asarray(rj.solver_status))
        np.testing.assert_array_equal(rt.status.numpy(), np.asarray(rj.status))
        np.testing.assert_array_equal(tc._last_iters.numpy(), np.asarray(jc._last_iters))
        np.testing.assert_array_equal(rt.is_feasible.numpy(), np.asarray(rj.is_feasible))
        np.testing.assert_allclose(rt.cmd.numpy(), np.asarray(rj.cmd), rtol=0, atol=1e-9)
        np.testing.assert_allclose(rt.cost.numpy(), np.asarray(rj.cost), rtol=0, atol=1e-9)
        np.testing.assert_allclose(tc.get_optimal_sequence().state.numpy(),
                                   np.asarray(jc.get_optimal_sequence().state),
                                   rtol=0, atol=1e-9)
        uj, ut = np.asarray(rj.cmd), rt.cmd.numpy()
        xj, xt = plant_np(xj, uj, noise[k]), plant_np(xt, ut, noise[k])
    assert (rt.status == 0).all() and int(tc._last_iters.max()) >= 2


def test_state_carried_from_the_jax_controller():
    """``convert.nlmpc_state_*``: after two JAX steps the port, loaded with
    the JAX controller's warm start, takes the third step exactly as the JAX
    controller does."""
    kw = dict(maximum_iteration=30, enable_warm_start=True)
    jc, tc = jax_vdp(**kw), torch_vdp(**kw)
    x, noise = vdp_inputs(4, 3)
    u = np.zeros((4, 1))
    for k in range(2):
        u = np.asarray(jc.optimize(x, u).cmd)
        x = plant_np(x, u, noise[k])
    state = convert.nlmpc_state_to_numpy(jc)
    convert.nlmpc_state_from_numpy(tc, state)
    assert tc._opt_vector.shape == (4, 26) and not tc._first_iteration
    rj, rt = jc.optimize(x, u), tc.optimize(x, u)
    np.testing.assert_array_equal(tc._last_iters.numpy(), np.asarray(jc._last_iters))
    np.testing.assert_allclose(rt.cmd.numpy(), np.asarray(rj.cmd), rtol=0, atol=1e-9)
    back = convert.nlmpc_state_to_numpy(tc)
    np.testing.assert_allclose(back["opt_vector"], np.asarray(jc._opt_vector), atol=1e-9)
    np.testing.assert_array_equal(back["lb"], state["lb"])


def test_fused_float32_loop_matches_jax_interpret():
    """float32, the slice's engine: B = 8, K = 4 closed loop through the
    port's fused solver (plain twin on CPU tensors) against the JAX
    package's fused path (the Pallas kernel in interpret mode).  Commands
    within 1e-3: float32 SQP iterates of two frameworks, compared by
    accuracy; iteration counts are float32-noise and are not compared."""
    B, K = 8, 4
    kw = dict(maximum_iteration=30, enable_warm_start=True, inner_qp="fused",
              hessian_reg="gershgorin")
    jc, tc = jax_vdp(jnp.float32, **kw), torch_vdp(torch.float32, **kw)
    x, noise = vdp_inputs(B, K)
    u = np.zeros((B, 1))
    for k in range(K):
        rj, rt = jc.optimize(x, u), tc.optimize(x, u)
        assert rt.cmd.dtype == torch.float32
        assert (rt.status == 0).all() and (np.asarray(rj.status) == 0).all()
        np.testing.assert_allclose(rt.cmd.numpy(), np.asarray(rj.cmd), rtol=0, atol=1e-3)
        assert (rt.cmd <= 0.5 + 1e-5).all()
        u = np.asarray(rj.cmd)
        x = plant_np(x, u, noise[k])


def test_failed_lane_holds_previous_command():
    """Failure semantics (NLOptimizer.hpp:613-624): a lane with a NaN state
    keeps its previous command, reports ERROR with cost inf and zeroed
    sequences; the other lanes are unaffected."""
    c = torch_vdp(maximum_iteration=30, enable_warm_start=True)
    x = np.array([[0.0, 1.0], [0.5, -0.5], [0.2, 0.3]])
    r0 = c.optimize(x, np.zeros((3, 1)))
    x[1] = np.nan
    r1 = c.optimize(x, r0.cmd)
    assert int(r1.status[1]) == int(lt.ResultStatus.ERROR)
    assert int(r1.solver_status[1]) == -1 and not bool(r1.is_feasible[1])
    assert torch.equal(r1.cmd[1], r0.cmd[1]) and torch.isinf(r1.cost[1])
    assert (c.get_optimal_sequence().state[1] == 0).all()
    assert (r1.status[[0, 2]] == 0).all() and torch.isfinite(r1.cmd[[0, 2]]).all()
    assert "roundoff" in r1.solver_status_msg


def test_cold_restart_on_failure_flags_only_failed_lanes():
    c = torch_vdp(maximum_iteration=30, enable_warm_start=True,
                  cold_restart_on_failure=True)
    x = np.array([[0.0, 1.0], [0.5, -0.5]])
    c.optimize(x, np.zeros((2, 1)))
    bad = x.copy()
    bad[1] = np.nan
    r1 = c.optimize(bad, np.zeros((2, 1)))
    assert r1.status.tolist() == [0, int(lt.ResultStatus.ERROR)]
    r2 = c.optimize(x, np.zeros((2, 1)))  # lane 1 re-enters from the cold guess
    assert (r2.status == 0).all() and torch.isfinite(r2.cmd).all()


def test_compacted_solve_equals_plain_solve():
    """``compact_stragglers``: chunks of 4 SQP iterations, then only the
    unfinished lanes — bitwise the plain batched solve (B = 130)."""
    x, _ = vdp_inputs(130, 1)
    kw = dict(maximum_iteration=30, hessian_reg="gauss_newton", inner_qp="pdip")
    a = torch_vdp(ph=4, ch=2, **kw)
    b = torch_vdp(ph=4, ch=2, compact_stragglers=True, **kw)
    ra, rb = a.optimize(x, np.zeros((130, 1))), b.optimize(x, np.zeros((130, 1)))
    assert torch.equal(ra.cmd, rb.cmd) and torch.equal(a._last_iters, b._last_iters)
    assert torch.equal(ra.solver_status, rb.solver_status)
    assert int(a._last_iters.max()) > tctl._CHUNK


def test_setters_bounds_and_refusals(tmp_path):
    c = lt.NLMPC(5, 3, 1, 7, 4, 0, 0, dtype=torch.float64, device="cpu")
    jc = lj.NLMPC(5, 3, 1, 7, 4, 0, 0)
    for ctl in (c, jc):
        assert ctl.set_state_bounds(np.full(5, -1.0), np.full(5, 1.0), lt.HorizonSlice(1, 3))
        assert ctl.set_input_bounds(np.full(3, -2.0), np.full(3, 2.0))
        assert not ctl.set_input_bounds(np.zeros(3), np.ones(3), lt.HorizonSlice(0, 5))
    np.testing.assert_array_equal(c.get_lower_bound(), jc.get_lower_bound())
    np.testing.assert_array_equal(c.get_upper_bound(), jc.get_upper_bound())
    assert c.get_lower_bound()[-1] == 0 and c.get_upper_bound()[-1] == 0
    c.set_optimizer_parameters(lt.NLParameters(hard_constraints=False))
    assert c.get_upper_bound()[-1] == np.inf  # the slack-bound rule
    assert not c.set_ineq_con_function(lambda X, Y, U, e: torch.zeros(0))
    assert not c.set_eq_con_function(lambda X, U: torch.zeros(0))
    with pytest.raises(RuntimeError, match="Output constraints"):
        c.set_output_bounds(np.zeros(1), np.ones(1))
    with pytest.raises(TypeError):
        c.set_optimizer_parameters(lt.LParameters())
    with pytest.raises(RuntimeError, match="state-space function"):
        c.optimize(np.zeros(5), np.zeros(3))
    c.save_state(str(tmp_path / "unsolved.npz"))  # no warm state yet: dims and flags only
    c.load_state(str(tmp_path / "unsolved.npz"))
    assert c._first_iteration and c._opt_vector is None
    with pytest.raises(ValueError):
        c.set_stats_mode("eager")
    assert c.is_prediction_horizon_slice_valid(lt.HorizonSlice(0, 7))
    assert not c.is_control_horizon_slice_valid(lt.HorizonSlice(2, 5))
    lo = np.full((2, 7, 5), -3.0)
    assert c.set_instance_bounds(state=(lo, -lo))
    with pytest.raises(ValueError, match="per-instance bounds"):
        c.set_state_space_function(lambda x, u, k: x)
        c.set_objective_function(lambda X, Y, U, e: torch.sum(X**2))
        c.optimize(np.zeros((3, 5)), np.zeros((3, 3)))


def test_instance_bounds_and_runtime_params_match_jax():
    """Per-lane input bounds and a batched runtime parameter (a per-lane
    state reference) through both controllers, float64: equal iterations,
    commands within 1e-9."""
    B = 3
    ref = np.array([[0.1, 0.0], [-0.2, 0.1], [0.0, 0.3]])
    lo = np.broadcast_to(np.array([-0.1, -0.2, -0.3])[:, None, None], (B, 5, 1))
    kw = dict(maximum_iteration=30)
    jc, tc = jax_vdp(**kw), torch_vdp(**kw)
    jc.set_objective_function(lambda X, Y, U, e, p: jnp.sum((X - p) ** 2) + jnp.sum(U**2))
    tc.set_objective_function(lambda X, Y, U, e, p: torch.sum((X - p) ** 2) + torch.sum(U**2))
    for ctl in (jc, tc):
        ctl.set_instance_bounds(input=(lo, np.full((B, 5, 1), 0.4)))
    jc.set_runtime_params(jnp.asarray(ref), batched=True)
    tc.set_runtime_params(ref, batched=True)
    x, _ = vdp_inputs(B, 1)
    rj, rt = jc.optimize(x, np.zeros((B, 1))), tc.optimize(x, np.zeros((B, 1)))
    np.testing.assert_array_equal(tc._last_iters.numpy(), np.asarray(jc._last_iters))
    np.testing.assert_allclose(rt.cmd.numpy(), np.asarray(rj.cmd), rtol=0, atol=1e-9)
    assert (rt.cmd[:, 0] >= torch.as_tensor(lo[:, 0, 0]) - 1e-9).all()


def test_status_map_matches_reference_table():
    codes = torch.tensor([tsqp.NLOPT_FAILURE, tsqp.NLOPT_ROUNDOFF_LIMITED,
                          tsqp.NLOPT_SUCCESS, tsqp.NLOPT_STOPVAL_REACHED,
                          tsqp.NLOPT_FTOL_REACHED, tsqp.NLOPT_XTOL_REACHED,
                          tsqp.NLOPT_MAXEVAL_REACHED, tsqp.NLOPT_MAXTIME_REACHED, 99])
    RS = lt.ResultStatus
    want = [RS.ERROR] * 2 + [RS.SUCCESS] * 4 + [RS.MAX_ITERATION] * 2 + [RS.UNKNOWN]
    assert tctl._status_from_nlopt(codes).tolist() == [int(w) for w in want]


@pytest.mark.parametrize("build", [
    lambda: lt.LMPC(2, 1, 1, 2, 3, 3), lambda: lt.NLMPC(2, 1, 2, 3, 3, 0, 0),
    lambda: lt.default_device()])
def test_entry_points_default_to_the_card_and_raise_without_one(build):
    """Without ``device`` the port runs on the CUDA card; where there is none
    it raises and names the missing card — it never gives way to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this test is about a machine without a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        build()


def _long_vdp(coupled, **params):
    """Van der Pol at ph = 60: n = 126, m = 307, past the fused kernel's
    shared-memory gate.  ``coupled`` adds (sum U)^2, which the structure
    probe rejects."""
    c = torch_vdp(torch.float32, ph=60, ch=5, **params)
    if coupled:
        c.set_objective_function(lambda X, Y, U, e: torch.sum(X**2) + torch.sum(U) ** 2)
    return c


@pytest.mark.parametrize("inner", ["admm", "fused"],
                         ids=["admm-inner_qp='admm'", "fused-shared-memory gate"])
def test_engine_requests_that_raise(inner):
    """The inner ``"admm"`` engine, and an oversize float32 ``"fused"``
    request without a verified banded plan, which the JAX package routes to
    it (both raised until the engine was ported): the per-instance ADMM
    serves them, its KKT inverse at n = 126 through the blocked recursion
    over K2 (the twin's leaves here)."""
    from libmpc_tpu_torch.ops import admm as tadmm
    from libmpc_tpu_torch.ops import batched_linalg as tbl

    c = _long_vdp(True, maximum_iteration=3, inner_qp=inner)
    assert c._get_traj_plan() is None
    widths = []
    blocked = tbl.chol_inverse_blocked

    def spy(C, *a):
        widths.append(C.shape[-1])
        return blocked(C, *a)

    tbl.chol_inverse_blocked, tadmm.admm_solve_each.trace = spy, []
    try:
        r = c.optimize(np.array([[0.3, -0.2], [0.1, 0.4]]), np.zeros((2, 1)))
        trace = tadmm.admm_solve_each.trace
    finally:
        tbl.chol_inverse_blocked, tadmm.admm_solve_each.trace = blocked, None
    assert len(trace) == int(c._last_iters.max()) and 126 in widths
    assert r.cmd.dtype == torch.float32 and bool(torch.isfinite(r.cmd).all())


def test_oversize_fused_request_with_a_plan_runs_the_banded_engine():
    """The same size with a stage-local objective: the float32 ``"fused"``
    request past the gate is served by the banded-KKT engine, as in the JAX
    package (``libmpc_tpu/ops/sqp.py:248-250``); an explicit ``"riccati"``
    request takes the same path."""
    from libmpc_tpu_torch.ops import trajectory_kkt as ttk

    x = np.array([[0.3, -0.2], [0.1, 0.4]])
    cmds = []
    for inner in ("fused", "riccati"):
        c = _long_vdp(False, maximum_iteration=20, inner_qp=inner)
        assert c._get_traj_plan() == ttk.TrajPlan(ph=60, ch=5, nx=2, nu=1, mi=61)
        ttk.ipm_solve.trace = []
        try:
            r = c.optimize(x, np.zeros((2, 1)))
            assert len(ttk.ipm_solve.trace) == int(c._last_iters.max())
        finally:
            ttk.ipm_solve.trace = None
        assert r.cmd.dtype == torch.float32 and (r.status == 0).all()
        cmds.append(r.cmd)
    assert torch.equal(cmds[0], cmds[1])


def test_ugv_float32_fused_request_runs_the_banded_engine():
    """The UGV NLP of examples/ugv_ex.py (nz = 61, m_qp = 123) in float32 with
    the default ``NLParameters``: the fused request is past the JAX package's
    fused size gate and the NLP's banded structure is verified, so the banded
    engine serves it, as in the JAX package, and not the fused kernel, whose
    shared memory would take the size."""
    from libmpc_tpu_torch.ops import qp_inner_fused as tqf
    from libmpc_tpu_torch.ops import trajectory_kkt as ttk

    nx, nu, ph, n_obs = 4, 2, 10, 2
    A = np.zeros((4, 4))
    A[0:2, 2:4] = np.eye(2)
    Bm = np.zeros((4, 2))
    Bm[2:4, 0:2] = np.eye(2)
    f32 = torch.float32
    Ad_t, Bd_t = (M.to(f32) for M in lt.discretization(A, Bm, 0.1))
    obstacles = torch.tensor([[2.0, 1.0], [1.0, 1.0]], dtype=f32)
    radii = torch.tensor([0.3, 0.3], dtype=f32)

    def objective(X, Y, U, e, p):
        v_err = X[:, 2:4] - p["v_pref"][None, :]
        return 1e3 * torch.sum(v_err**2) + 1e-2 * torch.sum(U**2) + 1e-5 * e * e

    def ineq(X, Y, U, e):
        d = torch.sqrt(torch.sum((X[:, None, 0:2] - obstacles[None]) ** 2, dim=-1))
        return (radii[None, :] - d).reshape(-1)

    c = lt.NLMPC(nx, nu, 4, ph, ph, (ph + 1) * n_obs, 0, dtype=f32, device="cpu")
    assert c.set_state_space_function(lambda x, u, k: Ad_t @ x + Bd_t @ u)
    assert c.set_output_function(lambda x, u, k: x)
    assert c.set_objective_function(objective)
    assert c.set_ineq_con_function(ineq)
    c.set_runtime_params({"v_pref": torch.tensor([0.7071, 0.7071])})
    c.set_optimizer_parameters(lt.NLParameters(maximum_iteration=4))
    d = c.dims
    me = d.ph * d.nx + d.eq
    assert (d.nz, me + d.ineq + d.nz) == (61, 123)
    plan = c._get_traj_plan()
    assert plan == ttk.TrajPlan(ph=ph, ch=ph, nx=nx, nu=nu, mi=(ph + 1) * n_obs)
    assert tsqp.inner_engine(c._params, f32, 61, 123,
                             tsqp.plan_applies(plan, c._params, 61, me, d.ineq)) == "riccati"
    assert tqf.supported(61, 123)
    ttk.ipm_solve.trace, tqf.solve_batched.trace = [], []
    try:
        r = c.optimize(np.array([[0.0, 0.0, 0.0, 0.0], [0.1, -0.1, 0.0, 0.0]]),
                       np.zeros((2, nu)))
        assert len(ttk.ipm_solve.trace) > 0 and tqf.solve_batched.trace == []
    finally:
        ttk.ipm_solve.trace = tqf.solve_batched.trace = None
    assert r.cmd.dtype == f32 and tuple(r.cmd.shape) == (2, nu)
    assert bool(torch.isfinite(r.cmd).all())
    assert (r.status == int(lt.ResultStatus.SUCCESS)).all(), r.status


def _ugv(pkg, dtype, ph, **kw):
    """The UGV NLP of ``bench.py:672-745`` (examples/ugv_ex.py) in either
    package, with its shipped float32 fleet settings: ``inner_qp="admm"``,
    ``hessian_reg="eigh"``, soft constraints, cold restarts of failed lanes
    and a batched velocity reference."""
    jax_side = pkg is lj
    T = (lambda a: jnp.asarray(a, dtype)) if jax_side else (lambda a: torch.as_tensor(a, dtype=dtype))
    total = (lambda v, ax=None: jnp.sum(v, axis=ax)) if jax_side else (
        lambda v, ax=None: torch.sum(v) if ax is None else torch.sum(v, dim=ax))
    sqrt = jnp.sqrt if jax_side else torch.sqrt
    A = np.zeros((4, 4))
    A[0:2, 2:4] = np.eye(2)
    Bm = np.zeros((4, 2))
    Bm[2:4, 0:2] = np.eye(2)
    Ad, Bd = (np.asarray(M) for M in lj.discretization(A, Bm, 0.1))
    Ad_t, Bd_t, obs, rad = T(Ad), T(Bd), T([[2.0, 1.0], [1.0, 1.0]]), T([0.3, 0.3])
    c = pkg.NLMPC(4, 2, 4, ph, ph, (ph + 1) * 2, 0, dtype=dtype, **kw)
    c.set_state_space_function(lambda x, u, k: Ad_t @ x + Bd_t @ u)
    c.set_output_function(lambda x, u, k: x)
    c.set_objective_function(
        lambda X, Y, U, e, p: 1e3 * total((X[:, 2:4] - p["v_pref"][None, :]) ** 2)
        + 1e-2 * total(U ** 2) + 1e-5 * e * e)
    c.set_ineq_con_function(
        lambda X, Y, U, e: (rad[None, :] - sqrt(total((X[:, None, 0:2] - obs[None]) ** 2, -1))
                            ).reshape(-1))
    c.set_optimizer_parameters(pkg.NLParameters(
        maximum_iteration=200, hard_constraints=False, enable_warm_start=True,
        inner_qp="admm", hessian_reg="eigh", relative_ftol=1e-6,
        cold_restart_on_failure=True))
    return c, Ad, Bd


def test_ugv_admm_engine_matches_jax_float64():
    """The UGV NLP at ph = 6 (the size of tests/test_examples.py), B = 4,
    four closed-loop steps: three starts of ``bench.py``'s
    ``default_rng(21)`` and one next to an obstacle.  Statuses, SQP
    iterations and every inner solve's per-lane ADMM iterations equal the JAX
    package's, commands within 1e-8."""
    import jax

    from libmpc_tpu.ops import admm as jadmm
    from libmpc_tpu_torch.ops import admm as tadmm

    B = 4
    jc, Ad, Bd = _ugv(lj, jnp.float64, 6)
    tc, _, _ = _ugv(lt, torch.float64, 6, device="cpu")
    assert tsqp.inner_engine(tc._params, torch.float64, 49, 49 + 24 + 14) == "admm"
    rng = np.random.default_rng(21)
    x = np.concatenate([0.2 * rng.normal(size=(B, 2)), np.zeros((B, 2))], axis=1)
    x[3] = [0.6, 0.95, 0.8, 0.0]
    u = np.zeros((B, 2))
    # each inner solve's (lane key, iterations): the key is a weighted sum of
    # the lane's gradient g, which the lanes do not share; the JAX package's
    # callbacks under vmap come one a lane, in no fixed order
    jax_inner, port_inner = [], []
    solve, solve_each = jadmm.admm_solve, tadmm.admm_solve_each

    def recorded(P, A, q, *a, **k):
        sol = solve(P, A, q, *a, **k)
        key = jnp.sum(q * jnp.arange(1, q.shape[-1] + 1))
        jax.debug.callback(lambda g0, it: jax_inner.append((float(g0), int(it))),
                           key, sol.iters)
        return sol

    def recorded_each(P, A, q, *a, **k):
        sol = solve_each(P, A, q, *a, **k)
        key = torch.sum(q * torch.arange(1, q.shape[-1] + 1), dim=-1)
        port_inner.append(list(zip(key.tolist(), sol.iters.tolist())))
        return sol

    recorded_each.trace = None

    jadmm.admm_solve, tadmm.admm_solve_each = recorded, recorded_each
    try:
        for _ in range(4):
            v = np.array([2.0, 2.0]) - x[:, :2]
            v /= np.maximum(np.linalg.norm(v, axis=1, keepdims=True), 1e-9)
            jc.set_runtime_params({"v_pref": jnp.asarray(v)}, batched=True)
            tc.set_runtime_params({"v_pref": v}, batched=True)
            del jax_inner[:], port_inner[:]
            rj, rt = jc.optimize(x, u), tc.optimize(x, u)
            its = np.asarray(jc._last_iters)
            np.testing.assert_array_equal(rt.status.numpy(), np.asarray(rj.status))
            np.testing.assert_array_equal(tc._last_iters.numpy(), its)
            np.testing.assert_allclose(rt.cmd.numpy(), np.asarray(rj.cmd), rtol=0, atol=1e-8)
            # the JAX package solves every lane's subproblem in each SQP
            # iteration of the batch (vmap), the port only the lanes still
            # iterating: each of those matches the JAX lane of the same key
            assert len(port_inner) == its.max() == len(jax_inner) // B
            for k, lanes in enumerate(port_inner):
                assert len(lanes) == (its > k).sum()
                want = jax_inner[k * B:(k + 1) * B]
                for g0, it in lanes:
                    near = min(want, key=lambda w: abs(w[0] - g0))
                    assert abs(near[0] - g0) <= 1e-6 * (1 + abs(g0)) and near[1] == it
            u = np.asarray(rj.cmd)
            x = x @ Ad.T + u @ Bd.T
    finally:
        jadmm.admm_solve, tadmm.admm_solve_each = solve, solve_each
    assert (rt.status == 0).all()
