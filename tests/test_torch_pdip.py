"""The port's interior-point QP solver (``ops/pdip.py``, batch-first) against
the JAX package's per-instance ``pdip_solve`` under ``vmap``, on the same
QPs made with numpy from a seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libmpc_tpu.ops import pdip as jpdip
from libmpc_tpu_torch.ops import pdip as tpdip


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def random_qps(B, nz, me, mi, seed, masked=2, slack=0.3, ridge=0.1):
    """Feasible QPs with box rows folded into Ji as the SQP folds them; the
    last ``masked`` inequality rows are padding (mask False, bound inf)."""
    rng = np.random.default_rng(seed)
    Q = rng.normal(size=(B, nz, nz))
    Bm = Q @ Q.transpose(0, 2, 1) / nz + ridge * np.eye(nz)
    g = rng.normal(size=(B, nz))
    x = rng.uniform(-0.5, 0.5, size=(B, nz))
    Je = rng.normal(size=(B, me, nz))
    be = np.einsum("bmn,bn->bm", Je, x)
    Ji = np.concatenate([rng.normal(size=(B, mi, nz)),
                         np.broadcast_to(np.eye(nz), (B, nz, nz)),
                         np.broadcast_to(-np.eye(nz), (B, nz, nz))], axis=1)
    bi = np.einsum("bmn,bn->bm", Ji, x) + np.abs(rng.normal(size=(B, mi + 2 * nz))) * slack
    mask = np.ones((B, mi + 2 * nz), bool)
    if masked:
        mask[:, -masked:] = False
        bi[:, -masked:] = np.inf
    return Bm, g, Je, be, Ji, bi, mask


def _both(data, dtype, **kw):
    jt = jnp.float64 if dtype == torch.float64 else jnp.float32
    jargs = [jnp.asarray(a) if a.dtype == bool else jnp.asarray(a, jt) for a in data]
    j = jax.vmap(lambda *a: jpdip.pdip_solve(*a, **kw))(*jargs)
    targs = [torch.as_tensor(a) if a.dtype == bool else torch.as_tensor(a, dtype=dtype)
             for a in data]
    return j, tpdip.pdip_solve(*targs, **kw)


@pytest.mark.parametrize("B,nz,me,mi,seed", [(6, 9, 3, 2, 0), (4, 27, 20, 11, 1),
                                             (3, 5, 0, 4, 2)])
def test_pdip_matches_jax_float64(B, nz, me, mi, seed):
    """float64: same per-lane iteration counts and statuses, d/nu/lam and the
    residual measures within 1e-9."""
    j, t = _both(random_qps(B, nz, me, mi, seed), torch.float64, eps=1e-10)
    np.testing.assert_array_equal(t.iters.numpy(), np.asarray(j.iters))
    np.testing.assert_array_equal(t.status.numpy(), np.asarray(j.status))
    assert (t.status == 1).all() and t.iters.dtype == torch.int32
    for name in ("d", "nu", "lam", "gap", "res"):
        np.testing.assert_allclose(getattr(t, name).numpy(), np.asarray(getattr(j, name)),
                                   rtol=0, atol=1e-9, err_msg=name)
    assert len(set(t.iters.tolist())) > 1 or B == 3  # lanes freeze on their own


def test_pdip_iteration_cap_and_final_refresh_match_jax():
    """A cap of 4 iterations stops every lane early: the refreshed gap and
    residual and the MAX_ITER status agree with the JAX package's."""
    j, t = _both(random_qps(5, 9, 3, 2, 4), torch.float64, n_iters=4, eps=1e-10)
    assert (t.iters == 4).all() and (t.status == -2).all()
    np.testing.assert_array_equal(t.status.numpy(), np.asarray(j.status))
    for name in ("d", "gap", "res"):
        np.testing.assert_allclose(getattr(t, name).numpy(), np.asarray(getattr(j, name)),
                                   rtol=0, atol=1e-9)


def test_pdip_float32_explicit_inverse_route():
    """float32 builds explicit inverses through ``batched_linalg.spd_inverse``
    (the plain twin on CPU tensors).  On the lanes both packages report
    solved, d agrees to 1e-4 with the JAX package's float32 run and with the
    port's float64 run (float32 interior-point systems reach condition
    numbers of 1e6; lanes at the float32 residual floor are not compared)."""
    data = random_qps(6, 9, 3, 2, 5, slack=1.0, ridge=1.0)
    j, t = _both(data, torch.float32, eps=1e-7)
    assert t.d.dtype == torch.float32
    ok = (t.status.numpy() == 1) & (np.asarray(j.status) == 1)
    assert ok.sum() >= 2
    np.testing.assert_allclose(t.d.numpy()[ok], np.asarray(j.d)[ok], rtol=0, atol=1e-4)
    _, t64 = _both(data, torch.float64, eps=1e-10)
    np.testing.assert_allclose(t.d.double().numpy()[ok], t64.d.numpy()[ok], rtol=0, atol=1e-4)
