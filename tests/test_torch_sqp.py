"""The port's batch-first SQP (``ops/sqp.py``) against the JAX package's
per-instance ``sqp_solve`` under ``vmap``, on a small Van der Pol NLP with
inputs made with numpy from a seed."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libmpc_tpu.dims import NLDims as JDims
from libmpc_tpu.nlmpc import problem as jnlp
from libmpc_tpu.ops import sqp as jsqp
from libmpc_tpu.types import NLParameters as JParams
from libmpc_tpu_torch.dims import NLDims
from libmpc_tpu_torch.nlmpc import problem as tnlp
from libmpc_tpu_torch.ops import _host
from libmpc_tpu_torch.ops import admm as tadmm
from libmpc_tpu_torch.ops import sqp as tsqp
from libmpc_tpu_torch.types import NLParameters

PH, CH = 6, 3
DIMS, JDIMS = NLDims(2, 1, 2, PH, CH, PH + 1, 0), JDims(2, 1, 2, PH, CH, PH + 1, 0)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _torch_nlp(dtype=torch.float64):
    fns = tnlp.NLFunctions(
        state_fn=lambda x, u, k: torch.stack(
            [(1.0 - x[1] * x[1]) * x[0] - x[1] + u[0], x[0]]),
        objective_fn=lambda X, Y, U, e: torch.sum(X**2) + torch.sum(U**2),
        ineq_fn=lambda X, Y, U, e: U[:, 0] - 0.5, continuous=True, ts=0.1)
    one = lambda k: torch.ones(k, dtype=dtype)
    a = (DIMS, fns, one(2), one(1))
    return (lambda z, x0: tnlp.objective(*a, z, x0),
            lambda z, x0: tnlp.state_defects(*a, z, x0),
            lambda z, x0: tnlp.user_ineq(*a, z, x0))


def _jax_solve(z0, x0, lb, ub, params):
    fns = jnlp.NLFunctions(
        state_fn=lambda x, u, k: jnp.stack(
            [(1.0 - x[1] * x[1]) * x[0] - x[1] + u[0], x[0]]),
        objective_fn=lambda X, Y, U, e: jnp.sum(X**2) + jnp.sum(U**2),
        ineq_fn=lambda X, Y, U, e: U[:, 0] - 0.5, continuous=True, ts=0.1)
    a = (JDIMS, fns, jnp.ones(2), jnp.ones(1))

    def one(z, x):
        return jsqp.sqp_solve(
            lambda zz: jnlp.objective(*a, zz, x),
            lambda zz: jnlp.state_defects(*a, zz, x),
            lambda zz: jnlp.user_ineq(*a, zz, x),
            z, jnp.asarray(lb), jnp.asarray(ub), params)

    return jax.vmap(one)(jnp.asarray(z0), jnp.asarray(x0))


def _inputs(B, seed=0):
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(-1.0, 1.0, size=(B, 2))
    z0 = np.concatenate([np.tile(x0, (1, PH)), np.zeros((B, CH + 1))], axis=1)
    lb = np.full(DIMS.nz, -np.inf)
    ub = np.full(DIMS.nz, np.inf)
    lb[-1] = ub[-1] = 0.0
    return z0, x0, lb, ub


def _torch_solve(z0, x0, lb, ub, params, **kw):
    f, ceq, cin = _torch_nlp()
    T = torch.as_tensor
    return tsqp.sqp_solve(f, ceq, cin, T(z0), T(lb), T(ub), params,
                          fn_args=(T(x0),), fn_in_dims=(0,), **kw)


@pytest.mark.parametrize("mode,inner", [
    ("gershgorin", "fused"), ("eigh", "pdip"), ("power", "pdip"),
    ("gauss_newton", "pdip"), ("bfgs", "pdip"), ("eigh", "admm")])
def test_sqp_matches_jax_float64(mode, inner):
    """float64 (a fused request runs the interior-point engine; "admm" the
    per-instance ADMM): per-lane statuses and SQP iteration counts equal, z
    and the objective at 1e-9."""
    z0, x0, lb, ub = _inputs(3)
    kw = dict(maximum_iteration=60, hessian_reg=mode, inner_qp=inner)
    j = _jax_solve(z0, x0, lb, ub, JParams(**kw))
    t = _torch_solve(z0, x0, lb, ub, NLParameters(**kw))
    np.testing.assert_array_equal(t.status.numpy(), np.asarray(j.status))
    np.testing.assert_array_equal(t.iters.numpy(), np.asarray(j.iters))
    assert t.status.dtype == torch.int32 and (t.status > 0).all()
    np.testing.assert_allclose(t.z.numpy(), np.asarray(j.z), rtol=0, atol=1e-9)
    np.testing.assert_allclose(t.obj.numpy(), np.asarray(j.obj), rtol=0, atol=1e-9)
    np.testing.assert_allclose(t.kkt_res.numpy(), np.asarray(j.kkt_res), rtol=0, atol=1e-9)


def test_sqp_tolerances_and_budget_statuses_match_jax():
    """xtol/ftol exits and the iteration budget (the time_limit contract):
    NLOPT_XTOL/FTOL_REACHED and NLOPT_MAXTIME_REACHED as the JAX package."""
    z0, x0, lb, ub = _inputs(3, seed=1)
    kw = dict(maximum_iteration=60, relative_ftol=1e-3, absolute_xtol=1e-3)
    j = _jax_solve(z0, x0, lb, ub, JParams(**kw))
    t = _torch_solve(z0, x0, lb, ub, NLParameters(**kw))
    np.testing.assert_array_equal(t.status.numpy(), np.asarray(j.status))
    np.testing.assert_array_equal(t.iters.numpy(), np.asarray(j.iters))
    assert set(t.status.tolist()) & {tsqp.NLOPT_FTOL_REACHED, tsqp.NLOPT_XTOL_REACHED}
    t = _torch_solve(z0, x0, lb, ub, NLParameters(maximum_iteration=60), iter_budget=2)
    assert (t.status == tsqp.NLOPT_MAXTIME_REACHED).all() and (t.iters == 2).all()
    t = _torch_solve(z0, x0, lb, ub, NLParameters(maximum_iteration=2))
    assert (t.status == tsqp.NLOPT_MAXEVAL_REACHED).all()


def test_chunked_run_equals_one_run():
    """``carry_in``/``it_hi``/``return_carry`` partition the same per-lane
    iteration sequence: begin, chunks of 2 and finish give bitwise the
    one-shot solution."""
    z0, x0, lb, ub = _inputs(4, seed=2)
    params = NLParameters(maximum_iteration=60)
    whole = _torch_solve(z0, x0, lb, ub, params)
    carry = _torch_solve(z0, x0, lb, ub, params, it_hi=0, return_carry=True)
    assert isinstance(carry, tsqp.Carry) and (carry.it == 0).all()
    for hi in range(2, 62, 2):
        carry = _torch_solve(z0, x0, lb, ub, params, carry_in=carry, it_hi=hi,
                             return_carry=True)
    assert (carry.it <= 60).all()
    parts = _torch_solve(z0, x0, lb, ub, params, carry_in=carry, it_hi=0)
    for a, b in zip(whole, parts):
        assert torch.equal(a, b)


@pytest.mark.parametrize("inner", ["admm", "fused"],
                         ids=["kw0-inner_qp='admm'", "kw1-shared-memory gate"])
def test_engines_not_ported_raise(inner):
    """The inner ``"admm"`` engine, and the oversize float32 ``"fused"``
    request without a banded plan that the JAX package hands to it, run the
    per-instance ADMM (they raised until it was ported): every lane's inner
    solve goes through ``admm_solve_each``, each SQP iteration solving the
    lanes still iterating only."""
    par = NLParameters(inner_qp=inner, maximum_iteration=8)
    for plan_ok in (False, True):
        assert tsqp.inner_engine(par, torch.float32, 301, 842, plan_ok) == (
            "admm" if inner == "admm" or not plan_ok else "riccati")
    z0, x0, lb, ub = _inputs(3)
    T = lambda a: torch.as_tensor(a, dtype=torch.float32)
    f, ceq, cin = _torch_nlp(torch.float32)
    fused_gate = tsqp._fused_size_ok
    tadmm.admm_solve_each.trace = []
    try:
        tsqp._fused_size_ok = lambda n, m: False  # this NLP's size past the gate
        sol = tsqp.sqp_solve(f, ceq, cin, T(z0), T(lb), T(ub), par,
                             fn_args=(T(x0),), fn_in_dims=(0,))
        trace = tadmm.admm_solve_each.trace
    finally:
        tsqp._fused_size_ok = fused_gate
        tadmm.admm_solve_each.trace = None
    assert len(trace) == int(sol.iters.max())
    assert [len(it) for it, _ in trace] == [int((sol.iters > k).sum()) for k in range(len(trace))]
    assert sol.z.dtype == torch.float32 and bool(torch.isfinite(sol.z).all())
    assert (sol.status > 0).all()


def test_fused_request_past_the_gate_raises_and_float64_routes_to_pdip():
    par = NLParameters(inner_qp="fused")
    assert tsqp.inner_engine(par, torch.float32, 26, 57) == "fused"
    assert tsqp.inner_engine(par, torch.float64, 26, 57) == "pdip"
    assert tsqp.inner_engine(par, torch.float32, 301, 842) == "admm"
    # what still raises: a shape within the JAX package's gate that the CUDA
    # kernel's shared memory would refuse (no such shape is known)
    from libmpc_tpu_torch.ops import qp_inner_fused

    supported = qp_inner_fused.supported
    qp_inner_fused.supported = lambda n, m, dtype: False
    try:
        with pytest.raises(NotImplementedError, match="shared-memory gate"):
            tsqp.inner_engine(par, torch.float32, 26, 57)
    finally:
        qp_inner_fused.supported = supported
    # with a verified banded plan (libmpc_tpu/ops/sqp.py:241-263): an explicit
    # request, a float64 fused request and an oversize float32 one run the
    # banded engine; a request the fused kernel can serve keeps it; without a
    # plan "riccati" degrades to pdip
    ric = dataclasses.replace(par, inner_qp="riccati")
    assert tsqp.inner_engine(ric, torch.float32, 26, 57, plan_ok=True) == "riccati"
    assert tsqp.inner_engine(ric, torch.float64, 26, 57) == "pdip"
    assert tsqp.inner_engine(par, torch.float32, 301, 842, plan_ok=True) == "riccati"
    assert tsqp.inner_engine(par, torch.float64, 26, 57, plan_ok=True) == "riccati"
    assert tsqp.inner_engine(par, torch.float32, 26, 57, plan_ok=True) == "fused"
    assert tsqp.inner_engine(dataclasses.replace(par, inner_qp="pdip"), torch.float32, 26, 57,
                             plan_ok=True) == "pdip"
    from libmpc_tpu_torch.ops.trajectory_kkt import TrajPlan
    plan = TrajPlan(ph=PH, ch=CH, nx=2, nu=1, mi=PH + 1)
    assert tsqp.plan_applies(plan, par, DIMS.nz, 2 * PH, PH + 1)
    assert not tsqp.plan_applies(plan, par, DIMS.nz, 2 * PH, PH)
    assert not tsqp.plan_applies(None, par, DIMS.nz, 2 * PH, PH + 1)
    assert not tsqp.plan_applies(plan, dataclasses.replace(par, hessian_reg="eigh"),
                                 DIMS.nz, 2 * PH, PH + 1)
    with pytest.raises(ValueError):
        tsqp.inner_engine(dataclasses.replace(par, inner_qp="simplex"), torch.float32, 26, 57)
    z0, x0, lb, ub = _inputs(2)
    with pytest.raises(ValueError, match="hessian_reg"):
        _torch_solve(z0, x0, lb, ub, NLParameters(hessian_reg="newton"))


# (nz, m_qp): Van der Pol (26, 57), shapes on both sides of the JAX
# package's fused gate, the UGV NLP of examples/ugv_ex.py (61, 123), the
# largest and smallest shapes the CUDA kernel's shared memory admits and
# refuses (103, 226) / (105, 231), the oscillators (301, 842), and a sweep of
# m_qp = 2 nz + 1 across the gate
GATE_GRID = ([(26, 57), (38, 80), (39, 90), (40, 92), (61, 123), (103, 226), (105, 231),
              (301, 842)] + [(nz, 2 * nz + 1) for nz in range(20, 61)])


@pytest.mark.parametrize("nz,m_qp", GATE_GRID)
def test_fused_size_gate_is_the_jax_packages(nz, m_qp):
    """The port's restated fused gate equals the JAX package's VMEM formula
    (``libmpc_tpu/ops/qp_inner_pallas.py:45-67``) and, where it admits a
    shape, the CUDA kernel takes it too."""
    from libmpc_tpu.ops import qp_inner_pallas
    from libmpc_tpu_torch.ops import qp_inner_fused

    assert tsqp._fused_size_ok(nz, m_qp) == qp_inner_pallas.supported(nz, m_qp)
    if tsqp._fused_size_ok(nz, m_qp):
        assert qp_inner_fused.supported(nz, m_qp)


def _jax_engine(inner_qp, f32, nz, m_qp, plan_ok):
    """The decision of ``libmpc_tpu/ops/sqp.py:218-263`` on a CPU (or TPU)
    backend, as a truth table: the engine's name, ``"admm"`` where the JAX
    package runs its inner ADMM."""
    from libmpc_tpu.ops import qp_inner_pallas

    fused_req = inner_qp == "fused"
    use_fused = fused_req and f32 and qp_inner_pallas.supported(nz, m_qp)
    use_traj = plan_ok and (inner_qp == "riccati" or (fused_req and not use_fused))
    use_pdip = not use_traj and (inner_qp in ("pdip", "riccati")
                                 or (fused_req and not use_fused and not f32))
    return ("fused" if use_fused else "riccati" if use_traj else "pdip" if use_pdip
            else "admm")


@pytest.mark.parametrize("nz,m_qp", GATE_GRID)
def test_inner_engine_routes_as_the_jax_package(nz, m_qp):
    """Every request (fused, riccati, pdip, admm), float32 and float64, with
    and without a verified banded plan, gets the JAX package's engine."""
    for inner in ("fused", "riccati", "pdip", "admm"):
        par = NLParameters(inner_qp=inner)
        for dtype in (torch.float32, torch.float64):
            for plan_ok in (True, False):
                want = _jax_engine(inner, dtype == torch.float32, nz, m_qp, plan_ok)
                assert tsqp.inner_engine(par, dtype, nz, m_qp, plan_ok) == want, (
                    inner, dtype, plan_ok)
    # the mid-size shapes the CUDA kernel would take: banded with a plan,
    # the per-instance ADMM without one, as in the JAX package; a kernel that
    # refused a shape within the gate would raise
    if (nz, m_qp) in ((40, 92), (61, 123)):
        fused = NLParameters(inner_qp="fused")
        assert tsqp.inner_engine(fused, torch.float32, nz, m_qp, True) == "riccati"
        assert tsqp.inner_engine(fused, torch.float32, nz, m_qp, False) == "admm"
        from libmpc_tpu_torch.ops import qp_inner_fused

        supported = qp_inner_fused.supported
        qp_inner_fused.supported = lambda n, m, dtype: False
        try:
            with pytest.raises(NotImplementedError, match="shared-memory gate"):
                tsqp.inner_engine(fused, torch.float32, 26, 57, False)
        finally:
            qp_inner_fused.supported = supported


def test_host_reads_are_counted():
    """Every loop test of the host-driven solver goes through ``_host``: one
    read per SQP iteration plus one per line-search trial and per
    interior-point iteration."""
    z0, x0, lb, ub = _inputs(2)
    _host.reads = 0
    t = _torch_solve(z0, x0, lb, ub, NLParameters(maximum_iteration=60))
    assert _host.reads > int(t.iters.max())


def test_second_order_correction_gate_is_the_jax_packages():
    """me = ph nx = 60 lies between the JAX package's exact-solve gate
    (k <= 52) and the CUDA Cholesky kernel's (k <= 64).  The second-order
    correction must take the JAX package's 16-step CG there, not the exact
    solve the kernel would allow: on this stiff, badly scaled NLP the two
    trial steps differ, and with the exact solve lanes 1 and 2 need 17 and
    16 SQP iterations where the JAX package needs 16 and 15."""
    import libmpc_tpu as lj
    import libmpc_tpu_torch as lt

    assert tsqp._SOC_EXACT_MAX == 52
    rates = np.geomspace(1.0, 300.0, 12)
    kj, kt = jnp.asarray(rates), torch.as_tensor(rates)

    def make(pkg, cls, P, f, **kw):
        c = cls(12, 1, 12, 5, 2, 6, 0, **kw)
        c.set_discretization_sampling_time(0.1)
        c.set_state_space_function(f)
        c.set_objective_function(lambda X, Y, U, e: pkg.sum(X**2) + pkg.sum(U**2))
        c.set_ineq_con_function(lambda X, Y, U, e: U[:, 0] - 0.5)
        c.set_state_scale(np.geomspace(0.05, 20.0, 12))
        c.set_optimizer_parameters(P(maximum_iteration=60, hessian_reg="gershgorin",
                                     inner_qp="pdip"))
        return c

    jc = make(jnp, lj.NLMPC, lj.NLParameters,
              lambda x, u, k: -kj * x - 5 * x**3 + jnp.roll(x, 1) + u[0], dtype=jnp.float64)
    tc = make(torch, lt.NLMPC, lt.NLParameters,
              lambda x, u, k: -kt * x - 5 * x**3 + torch.roll(x, 1) + u[0],
              dtype=torch.float64, device="cpu")
    assert tc.dims.ph * tc.dims.nx == 60
    x = np.random.default_rng(5).uniform(-1.5, 1.5, size=(6, 12))[[0, 1, 4]]
    rj, rt = jc.optimize(x, np.zeros((3, 1))), tc.optimize(x, np.zeros((3, 1)))
    assert tc._last_iters.tolist() == [14, 16, 15]
    np.testing.assert_array_equal(tc._last_iters.numpy(), np.asarray(jc._last_iters))
    np.testing.assert_array_equal(rt.status.numpy(), np.asarray(rj.status))
    np.testing.assert_allclose(tc._opt_vector.numpy(), np.asarray(jc._opt_vector),
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(rt.cmd.numpy(), np.asarray(rj.cmd), rtol=0, atol=1e-9)


class _EagerEvalGraph(tsqp._EvalGraph):
    """Each capture and replay of an SQP evaluation stood in for by the
    evaluation run eagerly on the graph's own input tensors, its results
    written into the same output tensors every time, as a replay writes
    them."""

    made: list = []

    def capture(self, inputs):
        type(self).made.append(self)
        self.inputs = tuple(torch.empty_like(t) for t in inputs)
        self.graph, self.outputs = "captured", None
        return True

    def replay(self):
        out = self.fn(*self.inputs)
        if self.outputs is None:
            self.outputs = out
        else:
            for buf, val in zip(self.outputs, out):
                buf.copy_(val)
        return self.outputs


class _EagerBlockGraph(tadmm._BlockGraph):
    """The per-instance ADMM's block graph, each replay stood in for by the
    block run eagerly on the graph's tensors."""

    _cache = {}

    def capture(self, params, check_every):
        self.args = (params, check_every)

    def run(self):
        self.need_update, self.rho_est = self.advance(*self.args)
        return self.state, self.need_update, self.rho_est


@pytest.mark.parametrize("mode,inner", [
    ("eigh", "admm"), ("bfgs", "pdip"), ("gauss_newton", "pdip")])
def test_evaluation_graph_bookkeeping_gives_the_eager_loop(monkeypatch, mode, inner):
    """The SQP loop's evaluations replayed as on the card (the first
    iteration eager, the derivative block and the merit evaluation captured
    once each in the second and replayed from then on), each replay stood in
    for by the evaluation run eagerly into the same output tensors: bitwise
    the eager loop; a one-iteration call captures nothing; ``evals`` counts
    every evaluation and ``replays`` all but the first iteration's; and no
    tensor of the carry (``g_prev``, ``Je_prev``, ``Ji_prev`` among them)
    shares storage with a replay's outputs."""
    z0, x0, lb, ub = _inputs(4, seed=3)
    params = NLParameters(maximum_iteration=40, hessian_reg=mode, inner_qp=inner)
    tsqp.evals = tsqp.replays = 0
    eager = _torch_solve(z0, x0, lb, ub, params, return_carry=True)
    eager_evals = tsqp.evals
    assert tsqp.replays == 0 and eager_evals >= 3 * int(eager.it.max())

    monkeypatch.setattr(tadmm, "_use_graphs", lambda device: True)
    monkeypatch.setattr(tadmm, "_BlockGraph", _EagerBlockGraph)
    monkeypatch.setattr(_EagerBlockGraph, "_cache", {})
    monkeypatch.setattr(tsqp, "_EvalGraph", _EagerEvalGraph)
    monkeypatch.setattr(_EagerEvalGraph, "made", [])
    tsqp.evals = tsqp.replays = 0
    one = _torch_solve(z0, x0, lb, ub, params, it_hi=1, return_carry=True)
    first_evals = tsqp.evals
    assert int(one.it.max()) == 1 and first_evals >= 2
    assert tsqp.replays == 0 and _EagerEvalGraph.made == []

    tsqp.evals = tsqp.replays = 0
    replayed = _torch_solve(z0, x0, lb, ub, params, return_carry=True)
    assert int(replayed.it.max()) >= 3
    assert len(_EagerEvalGraph.made) == 2  # the derivative block, the merit
    assert tsqp.evals == eager_evals
    assert tsqp.replays == tsqp.evals - first_evals
    for f in tsqp.Carry._fields:
        assert torch.equal(getattr(replayed, f), getattr(eager, f)), f
    kept = {t.untyped_storage().data_ptr() for g in _EagerEvalGraph.made for t in g.outputs}
    assert not kept & {t.untyped_storage().data_ptr() for t in replayed if t.numel()}
