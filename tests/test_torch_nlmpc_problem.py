"""The NLP core of the port (``nlmpc/problem.py``) against the JAX package's
on the same numpy inputs, float64, to 1e-12, with the reference's goldens
(test/NLMPC/test_common.cpp, test_constraints.cpp, test_objective.cpp)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd

from libmpc_tpu.dims import NLDims as JDims
from libmpc_tpu.nlmpc import problem as jnlp
from libmpc_tpu_torch.dims import NLDims
from libmpc_tpu_torch.nlmpc import problem as tnlp

MAPPING_SWEEP = [(1, 1, 1, 1), (5, 1, 1, 1), (5, 3, 1, 1),
                 (5, 3, 7, 1), (5, 3, 7, 4), (5, 3, 7, 7)]
TOL = 1e-12
T = lambda a: torch.as_tensor(np.asarray(a, float))


def close(got, want, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=tol)


def jvdp(x, u, k):
    return jnp.stack([(1.0 - x[1] * x[1]) * x[0] - x[1] + u[0], x[0]])


def tvdp(x, u, k):
    return torch.stack([(1.0 - x[1] * x[1]) * x[0] - x[1] + u[0], x[0]])


def _data(dims, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=dims.nz), rng.normal(size=dims.nx),
            rng.uniform(0.5, 2.0, size=dims.nx), rng.uniform(0.5, 2.0, size=dims.nu))


@pytest.mark.parametrize("nx,nu,ph,ch", MAPPING_SWEEP)
def test_unwrap_shift_and_guess_match_jax(nx, nu, ph, ch):
    dims, jd = NLDims(nx, nu, 1, ph, ch, 1, 1), JDims(nx, nu, 1, ph, ch, 1, 1)
    z, x0, ss, us = _data(dims, nx + ph + ch)
    tX, tU, ts = tnlp.unwrap(dims, T(z), T(x0), T(ss), T(us))
    jX, jU, js = jnlp.unwrap(jd, *map(jnp.asarray, (z, x0, ss, us)))
    close(tX, jX), close(tU, jU), close(ts, js)
    assert tX.shape == (ph + 1, nx) and tU.shape == (ph + 1, nu)
    # the reference's golden (test/NLMPC/test_common.cpp:46-106): with unit
    # scalings row i of X is z's i-th state block and U holds the blocked moves
    zg = np.arange(dims.nz, dtype=float)
    X, U, slack = tnlp.unwrap(dims, T(zg), T(-np.arange(1, nx + 1)), torch.ones(nx).double(),
                              torch.ones(nu).double())
    for i in range(1, ph + 1):
        assert np.array_equal(X[i].numpy(), zg[(i - 1) * nx: i * nx])
    for i in range(ph + 1):
        o = ph * nx + min(i, ch - 1) * nu
        assert np.array_equal(U[i].numpy(), zg[o: o + nu])
    assert float(slack) == zg[-1]
    close(tnlp.shift_warm_start(dims, T(z)), jnlp.shift_warm_start(jd, jnp.asarray(z)), 0)
    zb = np.stack([z, 2 * z])  # the port's shift takes a leading batch axis
    close(tnlp.shift_warm_start(dims, T(zb))[1], jnlp.shift_warm_start(jd, jnp.asarray(2 * z)), 0)
    u0 = np.arange(nu, dtype=float)
    close(tnlp.initial_guess(dims, T(x0), T(u0), 0.25, torch.float64),
          jnlp.initial_guess(jd, x0, u0, 0.25, jnp.float64), 0)
    gb = tnlp.initial_guess(dims, T(np.stack([x0, -x0])), T(np.stack([u0, u0])),
                            T([0.25, 0.5]))
    close(gb[1], jnlp.initial_guess(jd, -x0, u0, 0.5, jnp.float64), 0)


def test_vdp_trapezoidal_defect_and_jacobian_goldens():
    # (parity: test/NLMPC/test_constraints.cpp:60-142)
    dims, jd = NLDims(2, 1, 1, 2, 2, 0, 0), JDims(2, 1, 1, 2, 2, 0, 0)
    tf = tnlp.NLFunctions(state_fn=tvdp, continuous=True, ts=0.01)
    jf = jnlp.NLFunctions(state_fn=jvdp, continuous=True, ts=0.01)
    z = np.arange(dims.nz, dtype=float)
    one = lambda k: torch.ones(k, dtype=torch.float64)
    c = tnlp.state_defects(dims, tf, one(2), one(1), T(z), torch.zeros(2).double())
    assert np.allclose(c.numpy(), [0.035, -1.0, -2.05, -1.99], atol=1e-3)
    J = jacfwd(lambda zz: tnlp.state_defects(dims, tf, one(2), one(1), zz,
                                             torch.zeros(2).double()))(T(z))
    j_expected = np.array([
        [-1, -0.005, 0, 0, 0.01, 0, 0],
        [0.005, -1, 0, 0, 0, 0, 0],
        [1, -0.005, -1.04, -0.065, 0, 0.01, 0],
        [0.005, 1, 0.005, -1, 0, 0, 0],
    ])
    assert np.allclose(J.numpy(), j_expected, atol=1e-3)
    jdef = lambda zz: jnlp.state_defects(jd, jf, jnp.ones(2), jnp.ones(1), zz, jnp.zeros(2))
    close(c, jdef(jnp.asarray(z))), close(J, jax.jacfwd(jdef)(jnp.asarray(z)))


@pytest.mark.parametrize("continuous", [True, False])
def test_defects_with_scaling_match_jax(continuous):
    dims, jd = NLDims(2, 1, 2, 6, 3, 0, 0), JDims(2, 1, 2, 6, 3, 0, 0)
    z, x0, ss, us = _data(dims, 3)
    tf = tnlp.NLFunctions(state_fn=tvdp, continuous=continuous, ts=0.1)
    jf = jnlp.NLFunctions(state_fn=jvdp, continuous=continuous, ts=0.1)
    tdef = lambda zz: tnlp.state_defects(dims, tf, T(ss), T(us), zz, T(x0))
    jdef = lambda zz: jnlp.state_defects(jd, jf, *map(jnp.asarray, (ss, us)), zz, jnp.asarray(x0))
    close(tdef(T(z)), jdef(jnp.asarray(z)))
    close(jacfwd(tdef)(T(z)), jax.jacfwd(jdef)(jnp.asarray(z)))


def test_objective_golden_65730_and_gradient():
    # (parity: test/NLMPC/test_objective.cpp:56-62)
    dims = NLDims(5, 3, 1, 7, 7, 0, 0)
    fns = tnlp.NLFunctions(
        state_fn=lambda x, u, k: x,
        objective_fn=lambda X, Y, U, e: torch.sum(X**2) + torch.sum(U**2))
    z = T(np.arange(dims.nz))
    one = lambda k: torch.ones(k, dtype=torch.float64)
    f = lambda zz: tnlp.objective(dims, fns, one(5), one(3), zz, torch.zeros(5).double())
    assert float(f(z)) == 65730.0
    jd = JDims(5, 3, 1, 7, 7, 0, 0)
    jf = jnlp.NLFunctions(
        state_fn=lambda x, u, k: x,
        objective_fn=lambda X, Y, U, e: jnp.sum(X**2) + jnp.sum(U**2))
    jg = jax.grad(lambda zz: jnlp.objective(jd, jf, jnp.ones(5), jnp.ones(3), zz, jnp.zeros(5)))
    close(torch.func.grad(f)(z), jg(jnp.arange(dims.nz, dtype=jnp.float64)))


def test_output_function_user_constraints_and_runtime_params():
    """Output model, user inequality/equality plumbing
    (test/NLMPC/test_constraints.cpp:144-274) and a p-taking callback."""
    dims, jd = NLDims(2, 1, 2, 5, 5, 6, 1), JDims(2, 1, 2, 5, 5, 6, 1)
    z, x0, ss, us = _data(dims, 9)
    p = np.array([0.3, -0.7])
    tf = tnlp.NLFunctions(
        state_fn=tvdp, continuous=True, ts=0.1,
        output_fn=lambda x, u, k, p: torch.stack([x[0] * p[0], x[1] + u[0] * k]),
        objective_fn=lambda X, Y, U, e, p: torch.sum(Y**2) + e * p[1],
        ineq_fn=lambda X, Y, U, e: Y[:, 0] - 0.5,
        eq_fn=lambda X, U: X[0, 0][None])
    jf = jnlp.NLFunctions(
        state_fn=jvdp, continuous=True, ts=0.1,
        output_fn=lambda x, u, k, p: jnp.stack([x[0] * p[0], x[1] + u[0] * k]),
        objective_fn=lambda X, Y, U, e, p: jnp.sum(Y**2) + e * p[1],
        ineq_fn=lambda X, Y, U, e: Y[:, 0] - 0.5,
        eq_fn=lambda X, U: X[0, 0][None])
    targs = (dims, tf, T(ss), T(us), T(z), T(x0))
    jargs = (jd, jf, *map(jnp.asarray, (ss, us, z, x0)))
    close(tnlp.objective(*targs, T(p)), jnlp.objective(*jargs, jnp.asarray(p)))
    close(tnlp.user_ineq(*targs, T(p)), jnlp.user_ineq(*jargs, jnp.asarray(p)))
    close(tnlp.user_eq(*targs, T(p)), jnlp.user_eq(*jargs, jnp.asarray(p)))
    assert float(tnlp.user_eq(*targs, T(p))[0]) == x0[0] / ss[0]
    for tol in (1e-10, 10.0):
        got = tnlp.is_feasible(*targs, tol, tol, T(p))
        want = jnlp.is_feasible(*jargs, tol, tol, jnp.asarray(p))
        assert bool(got) == bool(want)
    X, U, _ = tnlp.unwrap(dims, T(z), T(x0), T(ss), T(us))
    assert tnlp.get_output(dims, tnlp.NLFunctions(), X, U).shape == (6, 2)


def test_fix_bounds_is_the_half_width_repair():
    z = np.array([0.0, 5.0, -3.0, 1.0])
    lb = np.array([-1.0, -1.0, -2.0, -np.inf])
    ub = np.array([1.0, 3.0, 4.0, np.inf])
    got = tnlp.fix_bounds(T(z), T(lb), T(ub))
    close(got, jnlp.fix_bounds(*map(jnp.asarray, (z, lb, ub))), 0)
    assert got.tolist() == [0.0, 2.0, 3.0, 1.0]  # (ub - lb) / 2, not the midpoint


def test_is_feasible_32_ulp_floor_in_float32():
    """A float32 iterate one ulp above an active bound is feasible under the
    floor, and infeasible in float64 at the user's 1e-10."""
    dims = NLDims(1, 1, 1, 2, 2, 3, 0)
    fns = tnlp.NLFunctions(state_fn=lambda x, u, k: x,
                           ineq_fn=lambda X, Y, U, e: U[:, 0] - 0.5)
    for dtype, want in ((torch.float32, True), (torch.float64, False)):
        z = torch.tensor([0.0, 0.0, 0.5 + 6e-8, 0.5, 0.0], dtype=dtype)
        one = torch.ones(1, dtype=dtype)
        ok = tnlp.is_feasible(dims, fns, one, one, z, torch.zeros(1, dtype=dtype),
                              1e-10, 1e-10)
        assert bool(ok) is want
