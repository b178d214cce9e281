"""K2's twin (the CPU path of ``chol_inverse``) against the Pallas kernel
``batched_linalg._chol_inverse_pallas`` run in interpret mode, and the
batch-first SPD helpers of the port."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libmpc_tpu.ops import batched_linalg as jbl
from libmpc_tpu_torch.ops import batched_linalg as tbl


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _spd_batch(B, k, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    Q = rng.normal(size=(B, k, k)).astype(dtype)
    return Q @ np.transpose(Q, (0, 2, 1)) / k + 0.5 * np.eye(k, dtype=dtype)


@pytest.mark.parametrize("B,k", [(37, 24), (5, 17), (130, 24)])
def test_twin_matches_pallas_interpret_float32(B, k):
    C = _spd_batch(B, k, seed=B)
    want = np.asarray(jbl._chol_inverse_pallas(jnp.asarray(C), interpret=True))
    got = tbl.chol_inverse(torch.as_tensor(C)).numpy()
    assert got.dtype == np.float32 and got.shape == (B, k, k)
    # two float32 inverses of well-conditioned SPD matrices
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_twin_float64_matches_numpy():
    C = _spd_batch(9, 24, seed=4, dtype=np.float64)
    got = tbl.chol_inverse(torch.as_tensor(C)).numpy()
    np.testing.assert_allclose(got, np.linalg.inv(C), rtol=0, atol=1e-12)


def test_twin_reports_non_spd_as_nan():
    C = _spd_batch(3, 6, seed=5, dtype=np.float64)
    C[1] = -C[1]
    got = tbl.chol_inverse(torch.as_tensor(C)).numpy()
    assert np.isnan(got[1]).all()
    assert np.isfinite(got[[0, 2]]).all()


def test_spd_inverse_and_solve_unbatched_and_batched():
    M = torch.as_tensor(_spd_batch(1, 12, seed=6, dtype=np.float64)[0])
    np.testing.assert_allclose(tbl.spd_inverse(M).numpy(), np.linalg.inv(M.numpy()),
                               atol=1e-12)
    r = torch.arange(12, dtype=torch.float64)
    np.testing.assert_allclose(tbl.spd_solve(M, r).numpy(),
                               np.linalg.solve(M.numpy(), r.numpy()), atol=1e-12)
    Mb = torch.as_tensor(_spd_batch(4, 12, seed=7, dtype=np.float64))
    rb = torch.ones((4, 12), dtype=torch.float64)
    np.testing.assert_allclose(tbl.spd_solve(Mb, rb).numpy(),
                               np.linalg.solve(Mb.numpy(), rb.numpy()[..., None])[..., 0],
                               atol=1e-12)


def test_kernel_gate_and_non_cpu_devices_never_reach_the_twin():
    assert tbl.kernel_supported(24) and tbl.kernel_supported(64)
    assert not tbl.kernel_supported(65)
    launches = tbl.chol_inverse.launches
    with pytest.raises(ValueError, match="unsupported device"):
        tbl.chol_inverse(torch.empty((2, 24, 24), device="meta"))
    assert tbl.chol_inverse.launches == launches


def test_batched_routes_past_the_kernel_gate_run_the_twin_on_cpu():
    """k > 64 is past the kernel's gate: CPU tensors run the twin at any k;
    on the card the same call runs the blocked recursion
    (tests/test_torch_cuda.py)."""
    Mb = torch.as_tensor(_spd_batch(3, 70, seed=8, dtype=np.float64))
    rb = torch.ones((3, 70), dtype=torch.float64)
    np.testing.assert_allclose(tbl.spd_inverse(Mb).numpy(), np.linalg.inv(Mb.numpy()),
                               atol=1e-11)
    np.testing.assert_allclose(tbl.spd_solve(Mb, rb).numpy(),
                               np.linalg.solve(Mb.numpy(), rb.numpy()[..., None])[..., 0],
                               atol=1e-11)


@pytest.mark.parametrize("k,block_k,leaf_k", [(130, 48, 64), (130, 7, 9), (65, 48, 64),
                                              (40, 48, 64)])
def test_blocked_recursion_matches_numpy(k, block_k, leaf_k):
    """``chol_inverse_blocked`` (the 2x2 block Schur recursion of
    ``libmpc_tpu/ops/batched_linalg.py:125``) against ``numpy.linalg.inv``,
    float64, at k = 130 with the kernel's block sizes and with forced small
    ones (many levels), at k = 65 (one split) and under the leaf size (no
    split); leaves run the twin on CPU tensors."""
    C = _spd_batch(5, k, seed=k, dtype=np.float64)
    got = tbl.chol_inverse_blocked(torch.as_tensor(C), block_k, leaf_k).numpy()
    assert got.shape == (5, k, k)
    np.testing.assert_allclose(got, np.linalg.inv(C), rtol=0, atol=1e-11)
    np.testing.assert_allclose(got, np.swapaxes(got, 1, 2), rtol=0, atol=1e-12)


def test_blocked_recursion_matches_jax_float32_and_checks_its_blocks():
    """Against the JAX package's ``_chol_inverse_blocked`` (its Pallas leaves
    in interpret mode), float32, k = 70: two float32 inverses of
    well-conditioned matrices."""
    C = _spd_batch(4, 70, seed=11)
    want = np.asarray(jbl._chol_inverse_blocked(jnp.asarray(C), interpret=True))
    got = tbl.chol_inverse_blocked(torch.as_tensor(C)).numpy()
    assert got.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    with pytest.raises(ValueError, match="block_k"):
        tbl.chol_inverse_blocked(torch.as_tensor(C), block_k=70, leaf_k=64)
    assert tbl.BLOCK_K == jbl._BLOCK_K
