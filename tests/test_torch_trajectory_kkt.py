"""The port's banded-KKT interior point (``libmpc_tpu_torch/ops/trajectory_kkt.py``)
against the JAX package's: block extraction, the structure probe, the
interior point itself and whole controllers with ``inner_qp="riccati"``, all
float64 on inputs made with numpy from a seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libmpc_tpu as lj
import libmpc_tpu_torch as lt
from libmpc_tpu.dims import NLDims as JDims
from libmpc_tpu.nlmpc import problem as jnlp
from libmpc_tpu.ops import sqp as jsqp
from libmpc_tpu.ops import trajectory_kkt as jtk
from libmpc_tpu_torch import convert
from libmpc_tpu_torch.ops import sqp as tsqp
from libmpc_tpu_torch.ops import trajectory_kkt as ttk
from libmpc_tpu_torch.ops import trajectory_sweeps as tts
from test_torch_nlmpc import jax_vdp, jvdp, torch_vdp

SHAPES = [(6, 4, 3, 2), (10, 5, 2, 1), (4, 1, 2, 2), (1, 1, 2, 1)]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


# -- block extraction ---------------------------------------------------------
@pytest.mark.parametrize("ph,ch,nx,nu", SHAPES)
def test_block_extraction_equals_jax(ph, ch, nx, nu):
    """``_h_blocks``, ``_stage_cols`` and ``_je_blocks`` with a leading batch
    axis against the JAX package's per-instance functions: pure gathers, so
    equal to 1e-15; ch = 1 (no staged move) and ph = 1 (no sub-diagonal
    block) included."""
    jplan = jtk.TrajPlan(ph=ph, ch=ch, nx=nx, nu=nu, mi=5)
    tplan = convert.traj_plan_from_fields(jplan)
    assert tplan == ttk.TrajPlan(ph=ph, ch=ch, nx=nx, nu=nu, mi=5)
    assert (tplan.nz, tplan.bs, tplan.bs_p, tplan.w) == (jplan.nz, jplan.bs, jplan.bs_p, jplan.w)
    nz, me = jplan.nz, ph * nx
    rng = np.random.default_rng(ph * 10 + ch)
    B = 3
    H = rng.normal(size=(B, nz, nz))
    H = H + np.swapaxes(H, 1, 2)
    Je, ce = rng.normal(size=(B, me, nz)), rng.normal(size=(B, me))
    Z = rng.normal(size=(B, 5, nz))
    T = torch.as_tensor
    pairs = [
        (ttk._h_blocks(tplan, T(H)), jax.vmap(lambda h: jtk._h_blocks(jplan, h))(jnp.asarray(H))),
        (ttk._stage_cols(tplan, T(Z)), jax.vmap(lambda z: jtk._stage_cols(jplan, z))(jnp.asarray(Z))),
        (ttk._je_blocks(tplan, T(Je), T(ce)),
         jax.vmap(lambda j, c: jtk._je_blocks(jplan, j, c))(jnp.asarray(Je), jnp.asarray(ce))),
    ]
    for got, want in pairs:
        assert len(got) == len(want)
        for g, w in zip(got, want):
            w = np.asarray(w)
            assert tuple(g.shape) == w.shape
            if w.size:
                assert np.abs(g.numpy() - w).max() <= 1e-15
    # an unbatched matrix goes through the same code
    one = ttk._h_blocks(tplan, T(H[0]))
    for g, w in zip(one, pairs[0][0]):
        assert torch.equal(g, w[0])
    assert [ttk._stage_of_slot(tplan, i) for i in range(nz)] == \
        [jtk._stage_of_slot(jplan, i) for i in range(nz)]


# -- the structure probe ------------------------------------------------------
def josc(x, u, k):
    """bench.py:565-578 (six coupled Van der Pol oscillators)."""
    pos, vel = x[0::2], x[1::2]
    dvel = (1.0 - pos**2) * vel - pos + u + 0.1 * (jnp.sum(pos) - 6 * pos)
    return jnp.stack([vel, dvel], axis=1).reshape(-1)


def tosc(x, u, k):
    pos, vel = x[0::2], x[1::2]
    dvel = (1.0 - pos**2) * vel - pos + u + 0.1 * (torch.sum(pos) - 6 * pos)
    return torch.stack([vel, dvel], dim=1).reshape(-1)


def jax_osc(ph=6, ch=3, **params):
    """The reduced oscillators of tests/test_trajectory_kkt.py:322 (nz = 91)."""
    c = lj.NLMPC(12, 6, 12, ph, ch, (ph + 1) * 6, 0, dtype=jnp.float64)
    c.set_discretization_sampling_time(0.1)
    c.set_state_space_function(josc)
    c.set_objective_function(lambda X, Y, U, e: jnp.sum(X**2) + jnp.sum(U**2))
    c.set_ineq_con_function(lambda X, Y, U, e: (U - 0.5).reshape(-1))
    c.set_optimizer_parameters(lj.NLParameters(**params))
    return c


def torch_osc(ph=6, ch=3, dtype=torch.float64, **params):
    c = lt.NLMPC(12, 6, 12, ph, ch, (ph + 1) * 6, 0, dtype=dtype, device="cpu")
    c.set_discretization_sampling_time(0.1)
    c.set_state_space_function(tosc)
    c.set_objective_function(lambda X, Y, U, e: torch.sum(X**2) + torch.sum(U**2))
    c.set_ineq_con_function(lambda X, Y, U, e: (U - 0.5).reshape(-1))
    c.set_optimizer_parameters(lt.NLParameters(**params))
    return c


def _coupled(mod, pkg):
    """(sum U)^2 couples non-adjacent blocked moves: not banded."""
    c = mod(inner_qp="riccati", hessian_reg="gauss_newton")
    c.set_objective_function(lambda X, Y, U, e: pkg.sum(X**2) + (pkg.sum(U)) ** 2)
    return c


def _with_equality(pkg, cls, P, kw):
    c = cls(2, 1, 2, 10, 5, 11, 2, **kw)
    c.set_discretization_sampling_time(0.1)
    c.set_optimizer_parameters(P(inner_qp="riccati", hessian_reg="gauss_newton"))
    c.set_state_space_function(jvdp if pkg is jnp else
                               (lambda x, u, k: torch.stack(
                                   [(1.0 - x[1] * x[1]) * x[0] - x[1] + u[0], x[0]])))
    c.set_objective_function(lambda X, Y, U, e: pkg.sum(X**2) + pkg.sum(U**2))
    c.set_ineq_con_function(lambda X, Y, U, e: U[:, 0] - 0.5)
    c.set_eq_con_function(lambda X, U: X[-1] * 0.0)
    return c


PROBES = {
    "vdp_gauss_newton": (lambda: jax_vdp(hessian_reg="gauss_newton"),
                         lambda: torch_vdp(hessian_reg="gauss_newton")),
    "vdp_gershgorin": (lambda: jax_vdp(), lambda: torch_vdp()),
    "oscillators": (lambda: jax_osc(hessian_reg="gauss_newton"),
                    lambda: torch_osc(hessian_reg="gauss_newton")),
    "coupling_objective": (lambda: _coupled(jax_vdp, jnp), lambda: _coupled(torch_vdp, torch)),
    "user_equality": (
        lambda: _with_equality(jnp, lj.NLMPC, lj.NLParameters, dict(dtype=jnp.float64)),
        lambda: _with_equality(torch, lt.NLMPC, lt.NLParameters,
                               dict(dtype=torch.float64, device="cpu"))),
    "eigh": (lambda: jax_vdp(hessian_reg="eigh"), lambda: torch_vdp(hessian_reg="eigh")),
    "bfgs": (lambda: jax_vdp(hessian_reg="bfgs"), lambda: torch_vdp(hessian_reg="bfgs")),
}


@pytest.mark.parametrize("case", list(PROBES))
def test_make_plan_equals_jax(case):
    """The probe (same numpy generator, same points) returns the JAX
    package's plan for Van der Pol and the reduced oscillators and ``None``
    for the three rejections of tests/test_trajectory_kkt.py:354-385."""
    jc, tc = (make() for make in PROBES[case])
    jplan, tplan = jc._get_traj_plan(), tc._get_traj_plan()
    if case in ("coupling_objective", "user_equality", "eigh", "bfgs"):
        assert jplan is None and tplan is None
    else:
        assert tplan == convert.traj_plan_from_fields(jplan)
        assert tplan.mi == tc.dims.ineq
    assert tc._get_traj_plan() is tplan  # probed once
    tc.set_input_bounds(np.full(tc.dims.nu, -1.0), np.full(tc.dims.nu, 1.0))
    assert tc._traj_plan == (None, False)  # a setter invalidates the cache


def test_make_plan_early_exits():
    """A problem of nz < 2 (nx + nu) stays dense; a callback that fails under
    the probe means the dense engines, never an error."""
    c = lt.NLMPC(2, 1, 2, 1, 1, 0, 0, dtype=torch.float64, device="cpu")
    c.set_state_space_function(lambda x, u, k: x + u[0])
    c.set_objective_function(lambda X, Y, U, e: torch.sum(X**2))
    assert c.dims.nz == 4 and c._get_traj_plan() is None

    def broken(X, Y, U, e):
        raise ValueError("no derivative here")

    b = torch_vdp(hessian_reg="gauss_newton")
    b.set_objective_function(broken)
    assert b._get_traj_plan() is None


# -- the interior point -------------------------------------------------------
PH, CH = 5, 3
JPLAN = jtk.TrajPlan(ph=PH, ch=CH, nx=2, nu=1, mi=PH + 1)


@pytest.fixture(scope="module")
def subproblems():
    """Two SQP subproblems of a small Van der Pol NLP linearized at random
    iterates (tests/test_trajectory_kkt.py:199-221), as numpy arrays with a
    leading batch axis, with two finite box rows and the pinned slack."""
    dims = JDims(2, 1, 2, PH, CH, PH + 1, 0)
    fns = jnlp.NLFunctions(
        state_fn=jvdp, objective_fn=lambda X, Y, U, e: jnp.sum(X**2) + jnp.sum(U**2),
        ineq_fn=lambda X, Y, U, e: U[:, 0] - 0.5, continuous=True, ts=0.1)
    one = (dims, fns, jnp.ones(2), jnp.ones(1))
    rng = np.random.default_rng(3)
    nz = dims.nz
    out = []
    for x0 in ([0.4, -0.3], [0.2, 0.5]):
        x0 = jnp.asarray(x0)
        z = jnp.asarray(rng.normal(size=nz) * 0.3)
        f = lambda zz: jnlp.objective(*one, zz, x0, None)
        ce = lambda zz: jnlp.state_defects(*one, zz, x0, None)
        ci = lambda zz: jnlp.user_ineq(*one, zz, x0, None)
        H = jax.hessian(f)(z)
        Bm = jsqp._gershgorin_convexify(0.5 * (H + H.T), nz, jnp.float64)
        out.append([np.asarray(a) for a in (
            Bm, jax.grad(f)(z), jax.jacfwd(ce)(z), ce(z), jax.jacfwd(ci)(z), ci(z))])
    Bm, g, Je, ce, Ji, ci = (np.stack(a) for a in zip(*out))
    lb, ub = np.full(nz, -np.inf), np.full(nz, np.inf)
    lb[-1] = ub[-1] = 0.0
    lb[2], ub[2] = -0.8, 0.8
    rho_q = 1e8 * (1.0 + np.abs(ce).sum(1) + np.maximum(ci, 0.0).sum(1))
    return Bm, g, Je, ce, Ji, ci, lb, ub, rho_q


def _jax_ipm(sub, lane_cap=None, warm_y=None, **kw):
    Bm, g, Je, ce, Ji, ci, lb, ub, rho_q = sub
    J = jnp.asarray

    def one(Bm, g, Je, ce, Ji, ci, rho, cap, wy):
        return jtk.ipm_solve(JPLAN, Bm, g, Je, ce, Ji, ci, J(lb), J(ub), rho,
                             lane_cap=None if lane_cap is None else cap,
                             warm_y=None if warm_y is None else wy, **kw)

    B = g.shape[0]
    cap = J(np.zeros(B, np.int32) if lane_cap is None else lane_cap)
    wy = J(np.zeros((B, 1)) if warm_y is None else warm_y)
    return jax.vmap(one)(J(Bm), J(g), J(Je), J(ce), J(Ji), J(ci), J(rho_q), cap, wy)


def _torch_ipm(sub, lane_cap=None, warm_y=None, **kw):
    T = torch.as_tensor
    return ttk.ipm_solve(
        convert.traj_plan_from_fields(JPLAN), *(T(a) for a in sub),
        lane_cap=None if lane_cap is None else T(lane_cap),
        warm_y=None if warm_y is None else T(warm_y), **kw)


def _assert_ipm_equal(t, j, d_tol=1e-10, dual_tol=1e-8):
    jn = convert.traj_ipm_solution_from_numpy({k: np.asarray(v) for k, v in j._asdict().items()})
    assert torch.equal(t.status, jn.status) and torch.equal(t.iters, jn.iters)
    assert t.status.dtype == torch.int32 and t.iters.dtype == torch.int32
    assert (t.d - jn.d).abs().max() <= d_tol
    for name in ("nu", "lam", "box_net"):
        assert (getattr(t, name) - getattr(jn, name)).abs().max() <= dual_tol, name
    np.testing.assert_allclose(t.gap.numpy(), jn.gap.numpy(), rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(t.res.numpy(), jn.res.numpy(), rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("n_iters", [1, 3, 8])
def test_ipm_solve_matches_jax_iteration_for_iteration(subproblems, n_iters):
    """After 1, 3 and 8 interior-point iterations: d within 1e-10, duals
    within 1e-8, status and iteration counts equal."""
    kw = dict(n_iters=n_iters, eps=1e-10)
    _assert_ipm_equal(_torch_ipm(subproblems, **kw), _jax_ipm(subproblems, **kw))


def test_ipm_solve_converged_equals_jax_and_the_dense_interior_point(subproblems):
    """Run to convergence: SOLVED on every lane as in the JAX package, and
    the step of the port's dense ``pdip`` engine on the same elastic
    subproblem (the construction of ``ops/sqp.py``'s pdip branch)."""
    from libmpc_tpu_torch.ops import pdip

    kw = dict(n_iters=40, eps=1e-10)
    t = _torch_ipm(subproblems, **kw)
    _assert_ipm_equal(t, _jax_ipm(subproblems, **kw))
    assert (t.status == 1).all() and int(t.iters.max()) < 40
    Bm, g, Je, ce, Ji, ci, lb, ub, rho_q = (torch.as_tensor(a) for a in subproblems)
    B, nz = g.shape
    mi = ci.shape[1]
    ci_pos = ci.clamp(min=0.0)
    B_aug = torch.zeros((B, nz + 1, nz + 1), dtype=torch.float64)
    B_aug[:, :nz, :nz] = Bm
    B_aug[:, nz, nz] = rho_q
    eye = torch.eye(nz, dtype=torch.float64).expand(B, nz, nz)
    zero = torch.zeros((B, nz, 1), dtype=torch.float64)
    Ji_all = torch.cat([torch.cat([Ji, -ci_pos[:, :, None]], 2),
                        torch.cat([eye, zero], 2), torch.cat([-eye, zero], 2)], 1)
    bi_all = torch.cat([-ci, ub.clamp(max=1e20).expand(B, nz), -lb.clamp(min=-1e20).expand(B, nz)], 1)
    mask = torch.cat([torch.ones((B, mi), dtype=torch.bool), torch.isfinite(ub).expand(B, nz),
                      torch.isfinite(lb).expand(B, nz)], 1)
    ref = pdip.pdip_solve(B_aug, torch.cat([g, torch.zeros((B, 1), dtype=torch.float64)], 1),
                          torch.cat([Je, -ce[:, :, None]], 2), -ce, Ji_all, bi_all, mask,
                          n_iters=40, eps=1e-10)
    assert (t.d - ref.d[:, :nz]).abs().max() <= 1e-8
    assert (t.nu - ref.nu).abs().max() <= 1e-6


def test_ipm_solve_warm_y_hook(subproblems):
    """An all-zero ``warm_y`` is the cold start, bit for bit; a carried one
    reaches the same optimum, as in the JAX package."""
    kw = dict(n_iters=40, eps=1e-10)
    cold = _torch_ipm(subproblems, **kw)
    wy = torch.cat([cold.nu, cold.lam, cold.box_net], dim=1).numpy()
    zero = _torch_ipm(subproblems, warm_y=np.zeros_like(wy), **kw)
    for a, b in zip(zero, cold):
        assert torch.equal(a, b)
    warm = _torch_ipm(subproblems, warm_y=wy, **kw)
    assert (warm.status == 1).all() and (warm.d - cold.d).abs().max() < 1e-7
    _assert_ipm_equal(warm, _jax_ipm(subproblems, warm_y=wy, **kw))
    # one warm lane beside one cold lane
    mixed = wy.copy()
    mixed[1] = 0.0
    m = _torch_ipm(subproblems, warm_y=mixed, **kw)
    assert torch.equal(m.d[1], cold.d[1]) and torch.equal(m.iters[0], warm.iters[0])


def test_ipm_solve_lane_cap_freezes_after_the_capped_update(subproblems):
    """``lane_cap``: lane 0 capped at 3 applies its third update and freezes
    (its iterate is the one of a 3-iteration run, its verdict is not plain
    SOLVED), lane 1 runs on; equal to the JAX package's."""
    caps = np.array([3, 40], np.int32)
    kw = dict(n_iters=40, eps=1e-10)
    t = _torch_ipm(subproblems, lane_cap=caps, **kw)
    _assert_ipm_equal(t, _jax_ipm(subproblems, lane_cap=caps, **kw))
    three = _torch_ipm(subproblems, n_iters=3, eps=1e-10)
    full = _torch_ipm(subproblems, **kw)
    assert int(t.iters[0]) == 3 and torch.equal(t.d[0], three.d[0])
    assert int(t.status[0]) != 1
    assert torch.equal(t.d[1], full.d[1]) and int(t.status[1]) == 1


def test_ipm_solve_float32_converges_and_traces(subproblems):
    """float32 (tests/test_trajectory_kkt.py::test_f32_converges): SOLVED
    below the residual floor; ``ipm_solve.trace`` collects the per-lane
    iteration counts of each call."""
    sub = [a.astype(np.float32) for a in subproblems[:-1]] + [np.full(2, 1e4, np.float32)]
    ttk.ipm_solve.trace = []
    try:
        out = _torch_ipm(sub, n_iters=30, eps=1e-7, eps_res=3e-5)
        trace = ttk.ipm_solve.trace
    finally:
        ttk.ipm_solve.trace = None
    assert out.d.dtype == torch.float32
    assert (out.status == 1).all() and (out.res < 3e-5).all()
    assert len(trace) == 1 and torch.equal(trace[0], out.iters)


def test_traj_factors_cross_the_bridge():
    """``convert.traj_factors_from_numpy``: factors the JAX package computed
    solve a right-hand side in the port exactly as the port's own do."""
    jplan = jtk.TrajPlan(ph=4, ch=2, nx=2, nu=1, mi=0)
    rng = np.random.default_rng(9)
    bs, w, ph = jplan.bs, jplan.w, jplan.ph
    D = rng.normal(size=(ph, bs, bs))
    D = D @ np.swapaxes(D, 1, 2) + np.eye(bs)
    D[:, jplan.bs_p:, jplan.bs_p:] *= -1.0
    D[:, :jplan.bs_p, jplan.bs_p:] = 0.0
    D[:, jplan.bs_p:, :jplan.bs_p] = 0.0
    L = 0.1 * rng.normal(size=(ph - 1, bs, bs))
    C = 0.1 * rng.normal(size=(ph, bs, w))
    G = 3.0 * np.eye(w)
    jf = jtk._traj_factor_seq(jplan, *(jnp.asarray(a) for a in (D, L, C, G)))
    tf = convert.traj_factors_from_numpy({k: np.asarray(v)[None] for k, v in jf._asdict().items()})
    tplan = convert.traj_plan_from_fields(jplan)
    own = ttk.traj_factor(tplan, *(torch.as_tensor(a)[None] for a in (D, L, C, G)))
    rs, rg = rng.normal(size=(1, ph, bs)), rng.normal(size=(1, w))
    a = ttk.traj_solve(tplan, tf, torch.as_tensor(rs), torch.as_tensor(rg))
    b = tts.batched_sweep_solve(*own, torch.as_tensor(rs), torch.as_tensor(rg))
    for x, y in zip(a, b):
        assert (x - y).abs().max() <= 1e-12


# -- whole controllers --------------------------------------------------------
def _loop(jc, tc, x, u, steps):
    for _ in range(steps):
        rj, rt = jc.optimize(x, u), tc.optimize(x, u)
        np.testing.assert_array_equal(rt.solver_status.numpy(), np.asarray(rj.solver_status))
        np.testing.assert_array_equal(rt.status.numpy(), np.asarray(rj.status))
        np.testing.assert_array_equal(tc._last_iters.numpy(), np.asarray(jc._last_iters))
        np.testing.assert_allclose(rt.cmd.numpy(), np.asarray(rj.cmd), rtol=0, atol=1e-8)
        np.testing.assert_allclose(rt.cost.numpy(), np.asarray(rj.cost), rtol=0, atol=1e-8)
        u = np.asarray(rj.cmd)
    return rt


@pytest.mark.parametrize("reg", ["gauss_newton", "gershgorin"])
def test_vdp_riccati_controller_matches_jax_and_pdip(reg):
    """Van der Pol, ``inner_qp="riccati"``, float64, a cold and a warm solve:
    statuses and SQP iteration counts equal to the JAX package's, commands
    within 1e-8; and within 1e-6 of the port's own ``pdip`` engine."""
    kw = dict(maximum_iteration=60, enable_warm_start=True, hessian_reg=reg)
    x = np.random.default_rng(0).uniform(-1, 1, size=(6, 2))
    u0 = np.zeros((6, 1))
    tc = torch_vdp(inner_qp="riccati", **kw)
    rt = _loop(jax_vdp(inner_qp="riccati", **kw), tc, x, u0, 2)
    assert (rt.status == 0).all()
    dims = tc.dims
    me = dims.ph * dims.nx
    assert tsqp.inner_engine(tc._params, tc.dtype, dims.nz, me + dims.ineq + dims.nz,
                             tsqp.plan_applies(tc._get_traj_plan(), tc._params, dims.nz, me,
                                               dims.ineq)) == "riccati"
    dense = torch_vdp(inner_qp="pdip", **kw)
    rd = dense.optimize(x, u0)
    rd = dense.optimize(x, rd.cmd)
    assert (rt.cmd - rd.cmd).abs().max() < 1e-6


def test_oscillators_riccati_controller_matches_jax_and_pdip():
    """The reduced networked oscillators (ph = 6, ch = 3, nz = 91) with the
    shipped curvature model and the shipped request ``inner_qp="fused"``,
    which float64 routes to the banded engine in both packages."""
    kw = dict(maximum_iteration=40, enable_warm_start=True, hessian_reg="gauss_newton")
    x = np.random.default_rng(13).uniform(-0.5, 0.5, size=(4, 12))
    u0 = np.zeros((4, 6))
    tc = torch_osc(inner_qp="fused", **kw)
    assert tc._get_traj_plan() == ttk.TrajPlan(ph=6, ch=3, nx=12, nu=6, mi=42)
    ttk.ipm_solve.trace = []
    try:
        rt = _loop(jax_osc(inner_qp="fused", **kw), tc, x, u0, 2)
        assert len(ttk.ipm_solve.trace) > 0  # the banded engine ran
    finally:
        ttk.ipm_solve.trace = None
    assert (rt.status == 0).all() and (rt.cmd <= 0.5 + 1e-8).all()
    dense = torch_osc(inner_qp="pdip", **kw)
    rd = dense.optimize(x, u0)
    rd = dense.optimize(x, rd.cmd)
    assert (rt.cmd - rd.cmd).abs().max() < 1e-6


def test_riccati_without_a_plan_runs_pdip():
    """A ``"riccati"`` request on an NLP the probe rejects degrades to the
    dense interior point and solves, as in the JAX package."""
    c = _coupled(torch_vdp, torch)
    assert c._get_traj_plan() is None
    ttk.ipm_solve.trace = []
    try:
        r = c.optimize(np.array([[0.3, -0.2]]), np.zeros((1, 1)))
        assert ttk.ipm_solve.trace == []
    finally:
        ttk.ipm_solve.trace = None
    assert (r.status == 0).all()
