"""The fused inner-QP solver's plain twin (``ops/qp_inner_fused.py``)
against the JAX package's Pallas kernel run in interpret mode, on the same
QPs made with numpy from a seed."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libmpc_tpu.ops import qp_inner_pallas as jqip
from libmpc_tpu_torch.ops import admm as tadmm
from libmpc_tpu_torch.ops import qp_inner_fused as tqip


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def sqp_like_qps(B, n, me, mi, seed=0, rho_eq=100.0, q_scale=1.0):
    """Feasible QPs in the form ``ops/sqp.py`` builds them: equality rows,
    one-sided rows with -inf, identity box rows of which some are infinite
    (the SQP clamps infinite bounds to +-1e20); rho per row as
    ``admm._rho_vec_of`` gives it (equality rows boosted, loose rows 1e-6)."""
    rng = np.random.default_rng(seed)
    m = me + mi + n
    Q = rng.normal(size=(B, n, n))
    P = Q @ Q.transpose(0, 2, 1) / n + 0.5 * np.eye(n)
    Aei = rng.normal(size=(B, me + mi, n)) / np.sqrt(n)
    A = np.concatenate([Aei, np.broadcast_to(np.eye(n), (B, n, n))], axis=1)
    x_feas = rng.uniform(-0.4, 0.4, size=(B, n))
    v = np.einsum("brn,bn->br", Aei, x_feas)
    q = q_scale * rng.normal(size=(B, n))
    be = v[:, :me]
    bi = v[:, me:] + 0.2 * np.abs(rng.normal(size=(B, mi)))
    lo = np.full((B, n), -0.5)
    hi = np.full((B, n), 0.5)
    lo[:, ::3] = -1e20
    hi[:, 1::3] = 1e20
    l = np.concatenate([be, np.full((B, mi), -np.inf), lo], axis=1)
    u = np.concatenate([be, bi, hi], axis=1)
    eq = np.arange(m) < me
    loose = (l <= -1e18) & (u >= 1e18)
    rho = np.where(loose, 1e-6, np.where(eq, rho_eq, 0.1))
    f = lambda a: a.astype(np.float32)
    return f(P), f(A), f(q), f(l), f(u), f(rho)


KW = dict(sigma=1e-5, alpha=1.6, eps_abs=5e-6, eps_rel=5e-6, max_iter=300,
          check_every=25)


def _both(data, B, n, m, **kw):
    j = jqip.solve_batched(
        *map(jnp.asarray, data), jnp.zeros((B, n), jnp.float32),
        jnp.zeros((B, m), jnp.float32), interpret=True, **kw)
    t = tqip.solve_batched(
        *[torch.as_tensor(a) for a in data], torch.zeros((B, n)),
        torch.zeros((B, m)), **kw)
    return [np.asarray(a) for a in j], [a.numpy() for a in t]


@pytest.mark.parametrize("B,n,me,mi,seed", [(5, 11, 4, 3, 1), (3, 7, 2, 1, 2)])
def test_plain_twin_matches_pallas_interpret_exactly(B, n, me, mi, seed):
    """float32, cold start, a mild equality penalty (rho 1.0) so that float32
    rounding is not amplified: ``done`` and the iteration count agree on
    every lane, x/y/z within 1e-5."""
    data = sqp_like_qps(B, n, me, mi, seed, rho_eq=1.0, q_scale=0.2)
    j, t = _both(data, B, n, me + mi + n, **KW)
    assert t[0].dtype == np.float32 and t[3].dtype == np.int32
    np.testing.assert_array_equal(t[4], j[4])
    assert t[4].all()
    np.testing.assert_array_equal(t[3], j[3])
    for got, want in zip(t[:3], j[:3]):
        assert np.abs(got - want).max() <= 1e-5


@pytest.mark.parametrize("B,me", [(8, 20), (37, 12)])
def test_plain_twin_matches_pallas_interpret_path_shape(B, me, capsys):
    """The SQP's shape (n = 26, mi = 11) at B = 8 and a ragged B = 37 with
    the SQP's own rho (equality rows at 100): after ONE check block (no rho
    adaptation yet) x/y/z and both residuals agree to 1e-3 of scale; run
    to the path's cap of 300, x is within 3e-4 of its scale on every lane
    and within 1e-4 where both converged, and ``done`` agrees on most lanes
    (observed 0.75 and 0.81; required 0.6).  The float32 iteration is ill-conditioned
    (equality penalty 100 against sigma 1e-5), so a lane at the threshold
    may stop some check blocks apart in the two frameworks: the counts are
    compared lane by lane and the differences printed, not hidden."""
    n, mi = 26, 11
    m = me + mi + n
    data = sqp_like_qps(B, n, me, mi, seed=3, rho_eq=100.0, q_scale=0.05)
    j, t = _both(data, B, n, m, **dict(KW, max_iter=25))
    for got, want in zip(t[:3] + t[5:], j[:3] + j[5:]):
        assert np.abs(got - want).max() <= 1e-3 * max(1.0, np.abs(want).max())
    np.testing.assert_array_equal(t[3], j[3])
    j, t = _both(data, B, n, m, **KW)
    apart = np.flatnonzero(t[3] != j[3])
    with capsys.disabled():
        print(f"\n[qp_inner B={B}] lanes whose iteration counts differ: "
              f"{len(apart)} of {B}; port {t[3][apart].tolist()} "
              f"JAX {j[3][apart].tolist()}")
    agree = t[4] == j[4]
    assert agree.mean() >= 0.6, (t[4], j[4])
    scale = max(1.0, np.abs(j[0]).max())
    assert np.abs(t[0] - j[0]).max() <= 3e-4 * scale
    both = t[4] & j[4]
    assert both.any()
    assert np.abs(t[0][both] - j[0][both]).max() <= 1e-4 * scale


def test_warm_start_at_the_optimum_stops_after_one_block():
    data = sqp_like_qps(4, 11, 4, 3, seed=3, rho_eq=1.0, q_scale=0.2)
    t = [torch.as_tensor(a) for a in data]
    x, y, *_ = tqip.solve_batched(*t, torch.zeros((4, 11)), torch.zeros((4, 18)), **KW)
    x2, y2, z2, iters, done, pri, dua = tqip.solve_batched(*t, x, y, **KW)
    assert done.all() and (iters == 25).all()
    assert (x2 - x).abs().max() <= 1e-4


def test_float64_twin_solves_to_kkt():
    """The twin is dtype-generic: in float64 with tight tolerances its answer
    satisfies the QP's optimality conditions to 1e-8."""
    P, A, q, l, u, rho = (torch.as_tensor(a).double()
                          for a in sqp_like_qps(6, 9, 3, 2, seed=4))
    x, y, z, iters, done, pri, dua = tqip.plain_solve_batched(
        P, A, q, l, u, rho, torch.zeros((6, 9), dtype=torch.float64),
        torch.zeros((6, 14), dtype=torch.float64), eps_abs=1e-10, eps_rel=1e-10,
        max_iter=4000)
    assert done.all()
    stat = torch.einsum("bij,bj->bi", P, x) + q + torch.einsum("bmn,bm->bn", A, y)
    assert stat.abs().max() <= 1e-8
    Ax = torch.einsum("bmn,bn->bm", A, x)
    assert (Ax - torch.clamp(Ax, min=l, max=u)).abs().max() <= 1e-8


def test_batched_ruiz_equals_per_instance():
    """``_ruiz_equilibration`` with a leading batch axis equals the same
    function applied to each instance (the JAX package vmaps it)."""
    P, A, q, *_ = (torch.as_tensor(a).double() for a in sqp_like_qps(3, 7, 2, 1, seed=5))
    d, e, c = tadmm._ruiz_equilibration(P, A, q, 10)
    for b in range(3):
        db, eb, cb = tadmm._ruiz_equilibration(P[b], A[b], q[b], 10)
        assert torch.equal(d[b], db) and torch.equal(e[b], eb) and torch.equal(c[b], cb)


def test_shared_memory_gate():
    assert tqip.supported(26, 57)
    assert tqip.supported(26, 57, torch.float64)
    assert tqip.smem_bytes(26, 57) == 4 * (57 * 27 + 3 * 26 * 27 + 6 * 26 + 7 * 57)
    assert not tqip.supported(301, 842)
