"""The port's ADMM solver against the independent C++ QP oracle
(``native/qp_oracle.cpp``) through the port's own binding
(``libmpc_tpu_torch.native_qp``): every case of tests/test_native_oracle.py
with the port's float64 ``admm_solve`` in place of the JAX package's, and
the two bindings of the one oracle against each other."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import libmpc_tpu_torch as lt
from libmpc_tpu import native_qp as jnative_qp
from libmpc_tpu_torch import native_qp
from libmpc_tpu_torch.ops import admm
from test_admm import kkt_error, random_qp

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the repository root's smoke script; imports no JAX)

TIGHT = lt.LParameters(**chip_smoke.ORACLE_PARAMS)


@pytest.fixture(autouse=True, scope="module")
def _oracle():
    if not native_qp.available():
        pytest.skip("native toolchain unavailable (g++)")
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _solve(P, A, q, l, u, **kw):
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)
    return admm.admm_solve(t(P), t(A), t(q), t(l), t(u), TIGHT, **kw)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_qp_agreement(seed):
    rng = np.random.default_rng(seed)
    P, A, q, l, u = random_qp(rng, 8, 12)
    sol = _solve(P, A, q, l, u)
    ref = native_qp.solve(P, A, q, l, u)
    assert ref.status == 1
    assert np.allclose(sol.x.numpy(), ref.x, atol=1e-6)
    assert kkt_error(P, A, q, l, u, ref.x, ref.y) < 1e-6


def test_equality_constrained_agreement():
    rng = np.random.default_rng(5)
    n, m = 6, 3
    P, A, q, _, _ = random_qp(rng, n, m)
    b = rng.normal(size=m)
    sol = _solve(P, A, q, b, b)
    ref = native_qp.solve(P, A, q, b, b)
    assert np.allclose(sol.x.numpy(), ref.x, atol=1e-6)


def test_quadrotor_qp_agreement():
    """The flagship QP: both solvers within 1e-5 of each other, and the
    oracle's solution reproduces the golden command."""
    dx, status, _, golden, _ = chip_smoke.oracle_quadrotor(torch, lt, "cpu")
    assert status == 1
    assert dx < 1e-5
    assert golden <= 1e-4


def test_bindings_agree_and_build_under_the_port():
    """The port's binding and the JAX package's load the same oracle: the
    same x on one QP within 1e-12 (tensors are accepted and copied to the
    host).  The port's library is its own build under ``_build/``."""
    rng = np.random.default_rng(3)
    P, A, q, l, u = random_qp(rng, 8, 12)
    got = native_qp.solve(*(torch.as_tensor(a) for a in (P, A, q, l, u)))
    want = jnative_qp.solve(P, A, q, l, u)
    assert got.status == want.status == 1 and got.iters == want.iters
    assert np.abs(got.x - want.x).max() <= 1e-12
    assert isinstance(got.x, np.ndarray) and got.x.dtype == np.float64
    lib = native_qp.build()
    assert lib.parent == native_qp.BUILD_DIR and lib.name.startswith("libqp_oracle_")
    with pytest.raises(ValueError, match="one dense QP"):
        native_qp.solve(P, A, q[:4], l, u)
