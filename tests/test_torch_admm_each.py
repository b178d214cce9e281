"""``admm_solve_each`` of the port (one QP a lane, the SQP's inner ``"admm"``
engine) against the JAX package's ``jax.vmap(admm_solve)`` over unbatched
instances, on QPs made with numpy from a seed: float64 statuses and
iteration counts equal lane by lane, x and y within 1e-9; float32 statuses
equal, x within 1e-4."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libmpc_tpu.ops import admm as jadmm
from libmpc_tpu.types import LParameters as JParams
from libmpc_tpu_torch.ops import admm as tadmm
from libmpc_tpu_torch.ops import sqp as tsqp

INF = np.inf
N_EQ = 3


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def lane_qp(rng, n, m, kind, n_eq=N_EQ):
    """One instance: a random SPD cost and a box around an achievable point,
    its first ``n_eq`` rows equalities.  ``kind`` adds: ``loose`` (four
    rows with no bound), ``flat`` (the cost scaled by 3e-3: the iterations
    crawl and stop at the cap), ``infeasible`` (two rows that
    contradict)."""
    L = rng.normal(size=(n, n))
    P = L @ L.T / n + np.eye(n)
    A = rng.normal(size=(m, n)) / np.sqrt(n)
    q = rng.normal(size=n)
    zc = rng.normal(size=n) @ A.T
    w = rng.uniform(0.1, 1.0, size=m)
    l, u = zc - w, zc + w
    l[:n_eq] = u[:n_eq] = zc[:n_eq]
    if kind == "loose":
        l[5:9], u[5:9] = -INF, INF
    elif kind == "flat":
        P = P * 3e-3
    elif kind == "infeasible":
        A[n_eq + 1] = A[n_eq]
        l[n_eq], u[n_eq] = 1.0, INF
        l[n_eq + 1], u[n_eq + 1] = -INF, -1.0
    return P, A, q, l, u


def qp_batch(n, m, lanes, n_eq=N_EQ):
    """A batch of instances, each (kind, seed)."""
    return [np.stack(t) for t in zip(*(
        lane_qp(np.random.default_rng(seed), n, m, kind, n_eq) for kind, seed in lanes))]


def solve_both(qp, params, dtype, eq, warm=None):
    """(JAX vmap of the per-instance solve, the port's per-lane solve)."""
    jd = jnp.float64 if dtype == torch.float64 else jnp.float32
    jp = JParams(**dataclasses.asdict(params))
    jeq = jnp.asarray(eq)
    warm = warm or ()

    def one(P, A, q, l, u, *w):
        kw = dict(warm_x=w[0], warm_y=w[1]) if w else {}
        return jadmm.admm_solve(P, A, q, l, u, jp, eq_mask=jeq, **kw)

    js = jax.vmap(one)(*(jnp.asarray(a, jd) for a in (*qp, *warm)))
    T = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype)
    kw = dict(warm_x=T(warm[0]), warm_y=T(warm[1])) if warm else {}
    ts = tadmm.admm_solve_each(*map(T, qp), params, eq_mask=torch.as_tensor(eq), **kw)
    return js, ts


def assert_float64_parity(js, ts):
    """Statuses and iteration counts equal, x, y and z within 1e-9.  An
    infeasible lane's y is its growing certificate (entries of 1e5 here), so
    it is compared as a direction: y / ||y||_inf."""
    np.testing.assert_array_equal(ts.status.numpy(), np.asarray(js.status))
    np.testing.assert_array_equal(ts.iters.numpy(), np.asarray(js.iters))
    cert = np.isin(ts.status.numpy(), (tadmm.OSQP_PRIMAL_INFEASIBLE, tadmm.OSQP_DUAL_INFEASIBLE))
    for field in ("x", "y", "z"):
        got, want = getattr(ts, field).numpy(), np.asarray(getattr(js, field))
        if field == "y":
            got, want = (np.where(cert[:, None], v / np.abs(v).max(1, keepdims=True), v)
                         for v in (got, want))
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9, err_msg=field)


# lanes 0 and 5 have 4 active inequality rows, lane 2 has 5
LANES = [("plain", 0), ("loose", 1), ("plain", 3), ("infeasible", 2), ("flat", 0),
         ("plain", 2)]


@pytest.mark.parametrize("polish_mode", ["shared", "dense"])
def test_float64_matches_jax_lane_by_lane(polish_mode):
    """Equality rows, rows with no bound, lanes whose rho moves, an
    infeasible lane, a lane at the iteration cap, and the polish accepted
    and rejected (a lane with more active rows than ``polish_active_cap``):
    the inner-QP settings of the float64 SQP, the cap lowered to 4; the
    dense per-lane polish as well."""
    par = dataclasses.replace(tsqp._qp_params(False), polish_active_cap=4,
                              polish_mode=polish_mode)
    qp = qp_batch(10, 24, LANES)
    eq = np.arange(24) < N_EQ
    sizes = []
    build = tadmm._build_kkt_inverse

    def spy(P, *a):
        sizes.append(P.shape[0])
        return build(P, *a)

    tadmm._build_kkt_inverse = spy
    try:
        js, ts = solve_both(qp, par, torch.float64, eq)
    finally:
        tadmm._build_kkt_inverse = build
    assert_float64_parity(js, ts)
    status = ts.status.tolist()
    assert status[3] == tadmm.OSQP_PRIMAL_INFEASIBLE
    assert status[4] == tadmm.OSQP_MAX_ITER_REACHED and int(ts.iters[4]) == par.maximum_iteration
    assert {status[i] for i in (0, 1, 2, 5)} == {tadmm.OSQP_SOLVED}
    assert np.array_equal(np.asarray(js.status), status)
    # the setup's factorization of all six lanes, then refactorizations of
    # only the lanes whose rho moved
    assert sizes[0] == 6 and len(sizes) > 1 and min(sizes[1:]) < 6
    unpolished = tadmm.admm_solve_each(
        *(torch.as_tensor(a) for a in qp), dataclasses.replace(par, polish=False),
        eq_mask=torch.as_tensor(eq))
    moved = (ts.x - unpolished.x).abs().amax(1) > 0
    assert moved[[0, 5]].all()  # accepted
    if polish_mode == "shared":
        assert not moved[2]  # rejected: 5 active rows, a correction for 4


def test_float64_warm_start_matches_jax():
    """The SQP's warm start (x0 = warm_x / d, y0 = warm_y / e * c)."""
    par = tsqp._qp_params(False)
    qp = qp_batch(10, 24, [("plain", 1), ("loose", 4), ("plain", 5)])
    eq = np.arange(24) < N_EQ
    cold = tadmm.admm_solve_each(*(torch.as_tensor(a) for a in qp), par,
                                 eq_mask=torch.as_tensor(eq))
    rng = np.random.default_rng(7)
    warm = (cold.x.numpy() + 1e-3 * rng.normal(size=cold.x.shape), cold.y.numpy())
    js, ts = solve_both(qp, par, torch.float64, eq, warm)
    assert_float64_parity(js, ts)
    assert (ts.iters <= cold.iters).all() and ts.iters.sum() < cold.iters.sum()


def test_lanes_are_independent():
    """Each lane alone gives bitwise what it gives in the batch: the loop may
    gather the lanes still running."""
    par = dataclasses.replace(tsqp._qp_params(False), maximum_iteration=300)
    qp = [torch.as_tensor(a) for a in qp_batch(10, 24, LANES)]
    eq = torch.as_tensor(np.arange(24) < N_EQ)
    whole = tadmm.admm_solve_each(*qp, par, eq_mask=eq)
    for b in range(len(LANES)):
        one = tadmm.admm_solve_each(*(a[b:b + 1] for a in qp), par, eq_mask=eq)
        for f in ("x", "y", "z", "status", "iters"):
            assert torch.equal(getattr(one, f)[0], getattr(whole, f)[b]), (b, f)


def test_float32_matches_jax():
    """Float32 inner-QP settings: statuses equal, x within 1e-4 (iteration
    counts are not compared in float32).  No equality rows: with them the
    float32 residuals sit at their rounding floor and a lane's verdict at the
    cap is a coin toss in either package."""
    par = tsqp._qp_params(True)
    lanes = [("plain", 0), ("loose", 1), ("plain", 2), ("infeasible", 3), ("plain", 4),
             ("plain", 5)]
    qp = qp_batch(10, 20, lanes, n_eq=0)
    js, ts = solve_both(qp, par, torch.float32, np.zeros(20, bool))
    assert ts.x.dtype == torch.float32
    np.testing.assert_array_equal(ts.status.numpy(), np.asarray(js.status))
    assert ts.status[3] == tadmm.OSQP_PRIMAL_INFEASIBLE
    ok = ts.status.numpy() == tadmm.OSQP_SOLVED
    assert ok.sum() == 5
    np.testing.assert_allclose(ts.x.numpy()[ok], np.asarray(js.x)[ok], rtol=0, atol=1e-4)


def test_float64_at_the_ugv_width():
    """n = 61, m = 123, the UGV subproblem's shape (K2's block tier on the
    card; its twin here)."""
    par = tsqp._qp_params(False)
    qp = qp_batch(61, 123, [("plain", 6), ("loose", 7), ("plain", 8)], n_eq=40)
    js, ts = solve_both(qp, par, torch.float64, np.arange(123) < 40)
    assert_float64_parity(js, ts)
    assert (ts.status == tadmm.OSQP_SOLVED).all()


def test_trace_records_each_call():
    qp = [torch.as_tensor(a) for a in qp_batch(6, 10, [("plain", 9), ("plain", 10)])]
    tadmm.admm_solve_each.trace = []
    try:
        sol = tadmm.admm_solve_each(*qp, tsqp._qp_params(False))
        (iters, status), = tadmm.admm_solve_each.trace
    finally:
        tadmm.admm_solve_each.trace = None
    assert torch.equal(iters, sol.iters) and torch.equal(status, sol.status)


def test_block_graph_bookkeeping_gives_the_eager_loop(monkeypatch):
    """The CUDA-graph path's bookkeeping (lanes padded to a power of two,
    the running lanes gathered into another graph's tensors, the
    refactorizations written in place) with each replay stood in for by the
    same block run eagerly on the graph's tensors: bitwise the eager loop."""

    class EagerGraph(tadmm._BlockGraph):
        _cache = {}

        def capture(self, params, check_every):
            self.args = (params, check_every)

        def run(self):
            self.need_update, self.rho_est = self.advance(*self.args)
            return self.state, self.need_update, self.rho_est

    par = dataclasses.replace(tsqp._qp_params(False), polish_active_cap=4)
    qp = [torch.as_tensor(a) for a in qp_batch(10, 24, LANES)]
    eq = torch.as_tensor(np.arange(24) < N_EQ)
    eager = tadmm.admm_solve_each(*qp, par, eq_mask=eq)
    monkeypatch.setattr(tadmm, "_BlockGraph", EagerGraph)
    monkeypatch.setattr(tadmm, "_use_graphs", lambda device: True)
    replayed = tadmm.admm_solve_each(*qp, par, eq_mask=eq)
    assert {key[0] for key in EagerGraph._cache} >= {8, 4, 2}  # 6 lanes, then fewer
    for f in ("x", "y", "z", "status", "iters"):
        assert torch.equal(getattr(replayed, f), getattr(eager, f)), f
