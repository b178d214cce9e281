"""The fused inner-QP solver's plain twin (``ops/qp_inner_fused.py``)
against the JAX package's Pallas kernel run in interpret mode, on the same
QPs made with numpy from a seed."""

import sys
from pathlib import Path

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
    """Each tier's own layout: the register tier's (32 m + 2696) words, the
    shared tier's (m ld + 3 n ld + 6 n + 7 m) with ld = n | 1."""
    assert tqip.supported(26, 57)
    assert tqip.supported(26, 57, torch.float64)
    assert tqip.smem_bytes(26, 57) == 4 * (32 * 57 + 2696)
    assert tqip.smem_bytes(26, 57, torch.float64) == 8 * (32 * 57 + 2696)
    assert tqip.smem_bytes(26, 184) == 4 * (184 * 27 + 3 * 26 * 27 + 6 * 26 + 7 * 184)
    assert not tqip.supported(301, 842)


@pytest.mark.parametrize("n,m,tier", [(1, 1, "register"), (26, 57, "register"),
                                      (32, 64, "register"), (33, 64, "shared"),
                                      (32, 65, "shared"), (26, 184, "shared"),
                                      (56, 1, "shared")])
def test_kernel_tier_is_a_function_of_the_shape(n, m, tier):
    assert tqip.tier(n, m) == tier


@pytest.mark.parametrize("n", range(1, 57))
def test_kernel_gate_admits_the_jax_fused_gate(n):
    """Every (n, m) the JAX package's fused gate admits, float32, is one the
    CUDA kernel takes (in one of its tiers): m from 1 to the largest the
    gate admits at this n.  The gate admits n up to 56."""
    m_max = 0
    while jqip.supported(n, m_max + 1):
        m_max += 1
    assert m_max >= 1
    for m in range(1, m_max + 1):
        assert tqip.supported(n, m, torch.float32), (n, m, tqip.tier(n, m))


def test_jax_fused_gate_stops_at_n_56():
    assert jqip.supported(56, 1) and not jqip.supported(56, 2)
    assert not jqip.supported(57, 1)


def test_refactorization_count_watches_the_twin_without_changing_it():
    """``chip_smoke.k3_refactorizations`` counts the lanes whose rho moved
    at each refactorization of the twin before its last check block: none
    with one block (the twin's refactorization after it is not the
    kernel's), and over several at least one and at most one per lane and
    block that the lane was still running after; the twin's result is the
    same with and without the count, and the library call is restored."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    B, n, me, mi = 6, 11, 4, 3
    P, A, q, l, u, rho = (torch.as_tensor(a) for a in sqp_like_qps(B, n, me, mi, seed=6))
    m = me + mi + n
    Ps, As, qs, ls, us, xs, ys, d, e, c = tqip._scale_problem(
        P, A, q, l, u, torch.zeros((B, n)), torch.zeros((B, m)), 10)
    args = (Ps, As, qs, ls, us, rho, xs, ys, 1 / d, 1 / e, 1 / c)
    kw = dict(KW, refine=True)
    real = torch.linalg.cholesky_ex
    assert chip_smoke.k3_refactorizations(torch, tqip, args, dict(kw, max_iter=25)) == 0
    moves = chip_smoke.k3_refactorizations(torch, tqip, args, kw)
    assert torch.linalg.cholesky_ex is real
    running = sum(int((~tqip._iterate_plain(*args, **dict(kw, max_iter=25 * k))[4]).sum())
                  for k in range(1, KW["max_iter"] // KW["check_every"]))
    assert 1 <= moves <= running
    plain = tqip._iterate_plain(*args, **kw)
    torch.linalg.cholesky_ex = lambda M, *a, **k: real(M, *a, **k)
    try:
        watched = tqip._iterate_plain(*args, **kw)
    finally:
        torch.linalg.cholesky_ex = real
    for a, b in zip(plain, watched):
        assert torch.equal(a, b)
