"""K1's twin (the CPU path of ``fused_iterations``) against the Pallas
kernel ``admm_pallas.fused_iterations`` run in interpret mode, at the shapes
of tests/test_admm_pallas.py, frozen lane included."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libmpc_tpu.ops import admm_pallas
from libmpc_tpu_torch.ops import admm_fused
from test_admm_pallas import _random_problem


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _as_torch(*arrays):
    return [torch.as_tensor(np.array(a)) for a in arrays]


@pytest.mark.parametrize("refine", [True, False])
@pytest.mark.parametrize("B,n,m", [(16, 8, 12), (32, 24, 40)])
def test_twin_matches_pallas_interpret(B, n, m, refine):
    P, A, q, l, u, M, Minv, rho = _random_problem(B, n, m)
    x = jnp.zeros((B, n), jnp.float32)
    z = jnp.zeros((B, m), jnp.float32)
    y = jnp.zeros((B, m), jnp.float32)
    done = jnp.zeros((B,), bool).at[3].set(True)  # one frozen lane
    want = admm_pallas.fused_iterations(
        x, z, y, done, q, l, u, A, M, Minv, rho,
        sigma=1e-5, alpha=1.6, k_iters=10, refine=refine, interpret=True,
    )
    tx, tz, ty, tdone, tq, tl, tu, tA, tM, tMinv, trho = _as_torch(
        x, z, y, done, q, l, u, A, M, Minv, rho)
    got = admm_fused.fused_iterations(
        tx, tz, ty, tdone, tq, tl, tu, tA, tM, tMinv, trho,
        sigma=1e-5, alpha=1.6, k_iters=10, refine=refine,
    )
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-4)
    # the frozen lane is untouched, bitwise
    for g, start in zip(got, (tx, tz, ty)):
        assert torch.equal(g[3], start[3])


def test_cpu_path_is_the_plain_loop():
    P, A, q, l, u, M, Minv, rho = _random_problem(8, 6, 9, seed=2)
    args = _as_torch(q, l, u, A, M, Minv, rho)
    state = [torch.zeros((8, 6)), torch.zeros((8, 9)), torch.zeros((8, 9))]
    done = torch.zeros(8, dtype=torch.bool)
    kw = dict(sigma=1e-5, alpha=1.6, k_iters=4, refine=True)
    a = admm_fused.fused_iterations(*state, done, *args, **kw)
    b = admm_fused.plain_iterations(*state, done, *args, **kw)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    # inactive rows end with an exactly zero dual
    clipped = (a[1] <= torch.as_tensor(np.array(l))) | (a[1] >= torch.as_tensor(np.array(u)))
    assert torch.all(a[2][~clipped] == 0)


def test_tile_gate():
    assert admm_fused.pick_tile(216, 535, torch.float32) == 8
    assert admm_fused.pick_tile(216, 535, torch.float64) == 4
    # three quadrotor blocks fit in one SM's shared memory
    assert 3 * admm_fused.smem_bytes(8, 216, 535, torch.float32) <= admm_fused.SMEM_LIMIT_BYTES
    assert admm_fused.pick_tile(2000, 5000, torch.float32) == 2
    assert admm_fused.pick_tile(4000, 10000, torch.float32) == 1
    with pytest.raises(ValueError, match="shared memory"):
        admm_fused.pick_tile(8000, 20000, torch.float64)


def test_non_cpu_devices_never_reach_the_twin():
    launches = admm_fused.fused_iterations.launches
    t = lambda *s: torch.empty(s, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        admm_fused.fused_iterations(
            t(4, 3), t(4, 5), t(4, 5), torch.empty(4, dtype=torch.bool, device="meta"),
            t(4, 3), t(4, 5), t(4, 5), t(5, 3), t(3, 3), t(3, 3), t(5),
            sigma=1e-5, alpha=1.6, k_iters=2,
        )
    assert admm_fused.fused_iterations.launches == launches
