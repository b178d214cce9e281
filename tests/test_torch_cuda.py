"""The two CUDA kernels against their plain twins, on the card.

These tests need a CUDA device and nvcc; without them they skip.  They
import neither JAX nor the JAX package, so on a machine without JAX run
them without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from libmpc_tpu_torch.ops import admm_fused, batched_linalg

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _k1_data(B, n, m, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    L = rng.normal(size=(n, n))
    P = L @ L.T + 0.5 * np.eye(n)
    A = rng.normal(size=(m, n))
    rho = np.full(m, 0.1)
    M = P + 1e-5 * np.eye(n) + (A.T * rho) @ A
    zc = rng.normal(size=(B, n)) @ A.T
    w = rng.uniform(0.3, 1.0, size=(B, m))
    l, u = zc - w, zc + w
    l[:, 0], u[:, 1] = -np.inf, np.inf
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return [t(rng.normal(size=(B, n))), t(l), t(u), t(A), t(M),
            t(np.linalg.inv(M)), t(rho)]


@pytest.mark.parametrize("dtype,refine,tol", [(torch.float32, True, 1e-4),
                                              (torch.float64, False, 1e-10)])
@pytest.mark.parametrize("B", [64, 37])
def test_fused_iterations_kernel_matches_twin(cuda, dtype, refine, tol, B):
    q, l, u, A, M, Minv, rho = _k1_data(B, 24, 40, dtype, cuda)
    x = torch.zeros((B, 24), dtype=dtype, device=cuda)
    z = torch.zeros((B, 40), dtype=dtype, device=cuda)
    y = torch.zeros((B, 40), dtype=dtype, device=cuda)
    done = torch.zeros(B, dtype=torch.bool, device=cuda)
    kw = dict(sigma=1e-5, alpha=1.6, refine=refine)
    x, z, y = admm_fused.plain_iterations(x, z, y, done, q, l, u, A, M, Minv, rho,
                                          k_iters=2, **kw)
    done[3] = True
    launches = admm_fused.fused_iterations.launches
    got = admm_fused.fused_iterations(x, z, y, done, q, l, u, A, M, Minv, rho,
                                      k_iters=10, **kw)
    want = admm_fused.plain_iterations(x, z, y, done, q, l, u, A, M, Minv, rho,
                                       k_iters=10, **kw)
    torch.cuda.synchronize()
    assert admm_fused.fused_iterations.launches == launches + 1
    for g, w, start in zip(got, want, (x, z, y)):
        assert (g - w).abs().max().item() <= tol * w.abs().max().item()
        assert torch.equal(g[3], start[3])


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.float64, 1e-10)])
def test_chol_inverse_kernel_matches_twin(cuda, dtype, tol):
    rng = np.random.default_rng(1)
    Q = rng.normal(size=(101, 24, 24))
    C = torch.as_tensor(Q @ Q.transpose(0, 2, 1) / 24 + 0.5 * np.eye(24),
                        dtype=dtype, device=cuda)
    launches = batched_linalg.chol_inverse.launches
    got = batched_linalg.chol_inverse(C)
    want = batched_linalg.chol_inverse_plain(C)
    torch.cuda.synchronize()
    assert batched_linalg.chol_inverse.launches == launches + 1
    assert (got - want).abs().max().item() <= tol * want.abs().max().item()


def test_kernels_refuse_what_they_do_not_take(cuda):
    with pytest.raises(ValueError, match="k <= 64"):
        batched_linalg.chol_inverse(torch.eye(65, device=cuda).expand(2, 65, 65).contiguous())
    with pytest.raises(TypeError):
        batched_linalg.chol_inverse(torch.eye(4, dtype=torch.float16, device=cuda)[None])
