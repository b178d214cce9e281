"""``admm_solve`` of the port against the JAX package in float64 on the QPs
of tests/test_admm.py: x/y to 1e-8, status and iteration counts equal."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libmpc_tpu.ops import admm as jadmm
from libmpc_tpu.types import LParameters as JParams
from libmpc_tpu_torch.ops import admm as tadmm
from libmpc_tpu_torch.types import LParameters
from test_admm import TIGHT, random_qp

INF = np.inf


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _case(name):
    """(P, A, q, l, u, params, extra admm_solve kwargs) of a named QP."""
    rng = np.random.default_rng
    if name == "equality":
        P, A, q, _, _ = random_qp(rng(1), 5, 2)
        b = rng(1).normal(size=2)
        return P, A, q, b, b, TIGHT, {}
    if name == "active_box":
        return (np.eye(3), np.eye(3), -np.ones(3), np.full(3, -0.5),
                np.full(3, 0.5), TIGHT, {})
    if name.startswith("random_kkt"):
        return (*random_qp(rng(int(name[-1])), 8, 12), TIGHT, {})
    if name == "mixed_loose":
        P, A, q, l, u = random_qp(rng(21), 6, 9, batch=4)
        l[0, :4], u[0, :4] = -INF, INF
        return P, A, q, l, u, TIGHT, {}
    if name == "primal_infeasible":
        return (np.eye(1), np.array([[1.0], [1.0]]), np.zeros(1),
                np.array([-INF, 1.0]), np.array([-1.0, INF]),
                LParameters(maximum_iteration=4000), {})
    if name == "dual_infeasible":
        return (np.zeros((1, 1)), np.eye(1), np.array([-1.0]), np.array([0.0]),
                np.array([INF]), LParameters(maximum_iteration=4000), {})
    if name in ("polish_shared", "polish_dense"):
        mode = name.split("_")[1]
        return (*random_qp(rng(5), 8, 12), LParameters(
            maximum_iteration=200, eps_abs=1e-3, eps_rel=1e-3, polish=True,
            polish_mode=mode), {})
    if name == "compaction":
        return (*random_qp(rng(0), 10, 17, batch=512), LParameters(
            maximum_iteration=200, rho=0.01, polish=True,
            polish_mode="shared"), {})
    if name.startswith("inaccurate"):
        base = dict(polish=False, check_termination=1, use_pallas=False,
                    compact_stragglers=False, eps_abs=1e-12, eps_rel=1e-12,
                    cold_start="zeros", stall_checks=0)
        if name == "inaccurate_primal":
            r = rng(3)
            A = r.normal(size=(8, 5))
            A[1] = A[0] * 1.7
            l, u = np.full(8, -1.0), np.full(8, 1.0)
            l[0], u[0] = 1.0, INF
            l[1], u[1] = -INF, -1.0
            return (np.eye(5), A, np.zeros(5), l, u, LParameters(
                eps_prim_inf=1e-9, maximum_iteration=38, **base), {})
        Bm = rng(5).normal(size=(2, 3))
        v = np.linalg.svd(Bm)[2][-1]
        return (Bm.T @ Bm, Bm, -v, np.full(2, -1.0), np.full(2, 1.0),
                LParameters(eps_dual_inf=1e-9, maximum_iteration=10, **base), {})
    knobs = LParameters(maximum_iteration=4000, eps_abs=1e-9, eps_rel=1e-9,
                        polish=False, use_pallas=False,
                        compact_stragglers=False)
    if name == "cold_start_kkt_duals":
        return (*random_qp(rng(3), 8, 14, batch=16), dataclasses.replace(
            knobs, cold_start="kkt_duals"), {})
    if name == "cold_rho":
        P, A, q, l, u = random_qp(rng(5), 8, 14, batch=16)
        return P, A, q, l, u, dataclasses.replace(
            knobs, cold_rho=0.5, enable_warm_start=True), dict(
            warm_x=np.zeros((16, 8)), warm_y=np.zeros((16, 14)), have_warm=False)
    if name == "time_limit":
        return (*random_qp(rng(2), 8, 12), TIGHT, dict(iter_budget=50))
    raise KeyError(name)


CASES = ["equality", "active_box", "random_kkt_0", "mixed_loose", "primal_infeasible", "dual_infeasible",
         "polish_shared", "polish_dense", "compaction", "inaccurate_primal",
         "inaccurate_dual", "cold_start_kkt_duals", "cold_rho", "time_limit"]


def _solve_both(P, A, q, l, u, params, extra):
    jp = JParams(**dataclasses.asdict(params))
    jx = {k: (jnp.asarray(v) if isinstance(v, (np.ndarray, bool)) else v)
          for k, v in extra.items()}
    tx = {k: (torch.as_tensor(np.array(v)) if isinstance(v, (np.ndarray, bool)) else v)
          for k, v in extra.items()}
    js = jadmm.admm_solve(*map(jnp.asarray, (P, A, q, l, u)), jp, **jx)
    ts = tadmm.admm_solve(*(torch.as_tensor(np.asarray(a, float))
                            for a in (P, A, q, l, u)), params, **tx)
    return js, ts


@pytest.mark.parametrize("name", CASES)
def test_admm_solve_matches_jax_float64(name):
    js, ts = _solve_both(*_case(name))
    np.testing.assert_array_equal(ts.status.numpy(), np.asarray(js.status))
    np.testing.assert_array_equal(ts.iters.numpy(), np.asarray(js.iters))
    for field in ("x", "y", "z"):
        want = np.asarray(getattr(js, field))
        got = getattr(ts, field).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-8, err_msg=field)


def test_warm_start_matches_jax_float64():
    P, A, q, l, u = random_qp(np.random.default_rng(3), 8, 10)
    p = LParameters(maximum_iteration=4000, eps_abs=1e-9, eps_rel=1e-9,
                    enable_warm_start=True, polish=False, check_termination=5)
    cold_j, cold_t = _solve_both(P, A, q, l, u, p, {})
    warm_j, warm_t = _solve_both(P, A, q, l, u, p, dict(
        warm_x=np.asarray(cold_j.x), warm_y=np.asarray(cold_j.y)))
    assert int(warm_t.iters) == int(warm_j.iters) <= int(cold_t.iters) / 2
    np.testing.assert_allclose(warm_t.x.numpy(), np.asarray(warm_j.x), atol=1e-8)


def test_prepared_without_polish_rebuilds_polish_base():
    P, A, q, l, u = (torch.as_tensor(a) for a in random_qp(np.random.default_rng(6), 8, 12))
    no_pol = LParameters(maximum_iteration=200, eps_abs=1e-3, eps_rel=1e-3, polish=False)
    with_pol = dataclasses.replace(no_pol, polish=True)
    eq = (l == u) & torch.isfinite(l)
    loose = (l <= -tadmm.INF_BOUND) & (u >= tadmm.INF_BOUND)
    prep_no = tadmm.prepare_qp(P, A, q.abs(), eq, loose, no_pol)
    assert prep_no.Mpinv is None
    a = tadmm.admm_solve(P, A, q, l, u, with_pol, prepared=prep_no)
    b = tadmm.admm_solve(P, A, q, l, u, with_pol,
                         prepared=tadmm.prepare_qp(P, A, q.abs(), eq, loose, with_pol))
    torch.testing.assert_close(a.x, b.x, rtol=0, atol=1e-12)


def _stall_state(dtype, pri_chk, stall_ct):
    """One lane at x = (1, 1) whose primal residual |Ax - z| is 3e-4 (inside
    the 10x band of eps_abs=1e-4) and whose dual residual 1e-5 did not move
    since the last check."""
    t = lambda v: torch.as_tensor(v, dtype=dtype)
    x = t([[1.0, 1.0]])
    z = t([[1.0 + 3e-4, 1.0]])
    y = torch.zeros((1, 2), dtype=dtype)
    state = tadmm._LoopState(
        x=x, z=z, y=y, x_prev=x, y_prev=y,
        iters=torch.tensor([30], dtype=torch.int32),
        done=torch.tensor([False]),
        status=torch.tensor([tadmm.OSQP_UNSOLVED], dtype=torch.int32),
        pri_res=t([3e-4]), dua_res=t([0.0]),
        inacc_status=torch.tensor([tadmm.OSQP_MAX_ITER_REACHED], dtype=torch.int32),
        pri_chk=t([pri_chk]), dua_chk=t([1e-5]),
        stall_ct=torch.tensor([stall_ct], dtype=torch.int32),
        rho=t(0.1), M=torch.eye(2, dtype=dtype), Minv=torch.eye(2, dtype=dtype),
    )
    eye, ones = torch.eye(2, dtype=dtype), torch.ones(2, dtype=dtype)
    q = -x + t([[1e-5, 0.0]])
    args = (eye, eye, q, t([[-5.0, -5.0]]), t([[5.0, 5.0]]), ones, ones, t(1.0))
    return state, args


@pytest.mark.parametrize("dtype,pri_chk,stall_ct,frozen", [
    (torch.float32, 3e-4, 2, True),    # third check without improvement
    (torch.float32, 3e-4, 0, False),   # first one: keep iterating
    (torch.float32, 1e-3, 2, False),   # improved >1%: the count resets
    (torch.float64, 3e-4, 2, False),   # the detector is float32-only
])
def test_stall_detection(dtype, pri_chk, stall_ct, frozen):
    """The stall detector (``libmpc_tpu/ops/admm.py:576-605``) freezes a lane
    whose residuals stopped improving inside the 10x band, with the verdict
    a max-iteration exit would report."""
    state, args = _stall_state(dtype, pri_chk, stall_ct)
    params = LParameters(eps_abs=1e-4, eps_rel=0.0, stall_checks=3,
                         adaptive_rho=False)
    out, need_update, _ = tadmm._termination_check(state, *args, params)
    assert not bool(need_update)
    assert bool(out.done[0]) == frozen
    want = tadmm.OSQP_SOLVED_INACCURATE if frozen else tadmm.OSQP_UNSOLVED
    assert int(out.status[0]) == want
    assert int(out.inacc_status[0]) == tadmm.OSQP_SOLVED_INACCURATE
    if dtype == torch.float32:
        assert int(out.stall_ct[0]) == (0 if pri_chk == 1e-3 else stall_ct + 1)


def test_compensated_arithmetic_is_exact():
    rng = np.random.default_rng(4)
    a = torch.as_tensor(rng.normal(size=1000), dtype=torch.float32)
    b = torch.as_tensor(rng.normal(size=1000) * 1e-5, dtype=torch.float32)
    s, e = tadmm._two_sum(a, b)
    assert torch.equal(s.double() + e.double(), a.double() + b.double())
    hi, lo = tadmm._split12(a)
    assert torch.equal(hi + lo, a)
    X = torch.as_tensor(rng.normal(size=(6, 64)), dtype=torch.float32)
    M = torch.as_tensor(rng.normal(size=(64, 5)), dtype=torch.float32)
    h, l_ = tadmm._comp_mm(X, M)
    exact = X.double() @ M.double()
    comp_err = (h.double() + l_.double() - exact).abs().max()
    plain_err = ((X @ M).double() - exact).abs().max()
    assert comp_err < 0.5 * plain_err
