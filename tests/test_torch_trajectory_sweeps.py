"""The twins of the trajectory factor and sweep kernels
(``libmpc_tpu_torch/ops/trajectory_sweeps.py``, the CPU path of
``batched_factor`` / ``batched_sweep_solve``) against the JAX package's
sequential recursions, its Pallas kernels in interpret mode and a dense
solve, on quasi-definite banded data made with numpy from a seed."""

import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (its stage-block generator; imports no JAX)
from libmpc_tpu.ops import trajectory_kkt as jtk
from libmpc_tpu.ops import trajectory_sweeps as jts
from libmpc_tpu_torch.ops import trajectory_kkt as ttk
from libmpc_tpu_torch.ops import trajectory_sweeps as tts

SHAPES = [(6, 4, 3, 2), (10, 5, 2, 1), (4, 1, 2, 2), (1, 1, 2, 1)]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def quasidef_banded(rng, plan):
    """A quasi-definite bordered block-tridiagonal matrix in the permuted
    stage layout (tests/test_trajectory_kkt.py:43-81): primal Gram over
    adjacent-stage rows and the border, negative-definite dual diagonal,
    banded cross coupling."""
    ph, bs, bs_p, w = plan.ph, plan.bs, plan.bs_p, plan.w
    n = ph * bs + w
    prim = np.concatenate(
        [np.arange(k * bs, k * bs + bs_p) for k in range(ph)] + [np.arange(ph * bs, n)])
    dual = np.concatenate([np.arange(k * bs + bs_p, (k + 1) * bs) for k in range(ph)])
    M = np.zeros((n, n))
    for k in range(ph):
        for _ in range(6):
            v = np.zeros(n)
            sl = np.arange(k * bs, k * bs + bs_p)
            if k + 1 < ph:
                sl = np.concatenate([sl, np.arange((k + 1) * bs, (k + 1) * bs + bs_p)])
            sl = np.concatenate([sl, np.arange(ph * bs, n)])
            v[sl] = rng.normal(size=sl.size)
            M += np.outer(v, v)
    M[prim[:, None], prim[None, :]] += 0.1 * np.eye(prim.size)
    M[dual[:, None], dual[None, :]] = -0.05 * np.eye(dual.size)
    for k in range(ph):
        rows = np.arange(k * bs + bs_p, (k + 1) * bs)
        cols = list(np.arange(k * bs, k * bs + bs_p)) + list(np.arange(ph * bs, n))
        if k:
            cols += list(np.arange((k - 1) * bs, (k - 1) * bs + bs_p))
        cols = np.asarray(cols)
        blk = rng.normal(size=(rows.size, cols.size))
        M[rows[:, None], cols[None, :]] = blk
        M[cols[:, None], rows[None, :]] = blk.T
    return M


def stage_blocks(Ms, plan):
    """(D, L, C, G) of a list of assembled matrices, batch axis leading."""
    ph, bs = plan.ph, plan.bs
    D = np.stack([[M[k*bs:(k+1)*bs, k*bs:(k+1)*bs] for k in range(ph)] for M in Ms])
    L = (np.stack([[M[k*bs:(k+1)*bs, (k-1)*bs:k*bs] for k in range(1, ph)] for M in Ms])
         if ph > 1 else np.zeros((len(Ms), 0, bs, bs)))
    C = np.stack([[M[k*bs:(k+1)*bs, ph*bs:] for k in range(ph)] for M in Ms])
    G = np.stack([M[ph*bs:, ph*bs:] for M in Ms])
    return D, L, C, G


def _case(ph, ch, nx, nu, B, seed):
    plan = jtk.TrajPlan(ph=ph, ch=ch, nx=nx, nu=nu, mi=3)
    rng = np.random.default_rng(seed)
    Ms = [quasidef_banded(rng, plan) for _ in range(B)]
    return plan, rng, Ms, stage_blocks(Ms, plan)


@pytest.mark.parametrize("ph,ch,nx,nu", SHAPES)
def test_twins_match_the_sequential_recursions_float64(ph, ch, nx, nu):
    """``traj_factor_plain`` + the border inverse against ``_traj_factor_seq``
    and ``traj_solve_plain`` against ``_traj_solve_seq`` (vmapped), 1e-12 of
    scale; ph = 1 (no sub-diagonal block) and ch = 1 included."""
    plan, rng, Ms, blocks = _case(ph, ch, nx, nu, 3, ph * 100 + ch)
    r = rng.normal(size=(3, ph * plan.bs + plan.w))
    rs, rg = r[:, :ph * plan.bs].reshape(3, ph, plan.bs), r[:, ph * plan.bs:]
    jf = jax.vmap(lambda d, l, c, g: jtk._traj_factor_seq(plan, d, l, c, g))(
        *(jnp.asarray(a) for a in blocks))
    jx = jax.vmap(lambda s, l, x, gi, a, b: jtk._traj_solve_seq(
        plan, jtk.TrajFactors(s, l, x, gi), a, b))(*jf, jnp.asarray(rs), jnp.asarray(rg))
    tplan = ttk.TrajPlan(ph=ph, ch=ch, nx=nx, nu=nu, mi=3)
    tf = ttk.traj_factor(tplan, *(torch.as_tensor(a) for a in blocks))
    tx = ttk.traj_solve(tplan, tf, torch.as_tensor(rs), torch.as_tensor(rg))
    assert tf.L.shape == (3, ph - 1, plan.bs, plan.bs)
    for got, want in list(zip(tf, jf)) + list(zip(tx, jx)):
        want = np.asarray(want)
        assert got.shape == want.shape
        if want.size:
            assert np.abs(got.numpy() - want).max() <= 1e-12 * max(1.0, np.abs(want).max())


@pytest.mark.parametrize("ph,ch,nx,nu", SHAPES)
def test_twins_solve_the_assembled_matrix(ph, ch, nx, nu):
    """Factor + solve against ``numpy.linalg.solve`` of the dense
    quasi-definite matrix: 1e-9 relative on every lane."""
    plan, rng, Ms, blocks = _case(ph, ch, nx, nu, 4, ph * 100 + ch + 1)
    r = rng.normal(size=(4, ph * plan.bs + plan.w))
    Sinv, X, Ghat = tts.batched_factor(*(torch.as_tensor(a) for a in blocks), plan.bs_p)
    Gi = torch.linalg.inv(0.5 * (Ghat + Ghat.transpose(1, 2)))
    xs, xg = tts.batched_sweep_solve(
        Sinv, torch.as_tensor(blocks[1]), X, Gi,
        torch.as_tensor(r[:, :ph * plan.bs].reshape(4, ph, plan.bs)),
        torch.as_tensor(r[:, ph * plan.bs:]))
    for b in range(4):
        ref = np.linalg.solve(Ms[b], r[b])
        x = np.concatenate([xs[b].numpy().ravel(), xg[b].numpy()])
        assert np.abs(x - ref).max() / np.abs(ref).max() < 1e-9


@pytest.mark.parametrize("ph,ch,nx,nu", [(6, 4, 3, 2), (5, 3, 2, 1)])
def test_factor_twin_matches_pallas_interpret_float32(ph, ch, nx, nu):
    """Against the Pallas factor kernels in interpret mode, float32, 1e-3
    relative on Sinv, X and the symmetrized border inverse (the tolerance of
    tests/test_trajectory_kkt.py:167-169)."""
    plan, rng, Ms, blocks = _case(ph, ch, nx, nu, 3, 5)
    b32 = [a.astype(np.float32) for a in blocks]
    Sk, Xk, Gk = jts.batched_factor(*(jnp.asarray(a) for a in b32), plan.bs_p,
                                    interpret=True)
    St, Xt, Gt = tts.batched_factor(*(torch.as_tensor(a) for a in b32), plan.bs_p)
    assert St.dtype == torch.float32
    inv = lambda G: np.linalg.inv(0.5 * (G + np.swapaxes(G, -1, -2)).astype(np.float64))
    for got, want in ((St.numpy(), np.asarray(Sk)), (Xt.numpy(), np.asarray(Xk)),
                      (inv(Gt.numpy()), inv(np.asarray(Gk)))):
        assert np.abs(got - want).max() / (np.abs(want).max() + 1e-9) < 1e-3


@pytest.mark.parametrize("ph,ch,nx,nu", [(6, 4, 3, 2), (20, 10, 12, 6)])
def test_sweep_twin_matches_pallas_interpret_float32(ph, ch, nx, nu):
    """Against the Pallas sweep kernels in interpret mode, float32, 1e-5 of
    scale (tests/test_trajectory_kkt.py:110-135's data), at the oscillators'
    own stage shape too."""
    plan = jtk.TrajPlan(ph=ph, ch=ch, nx=nx, nu=nu, mi=3)
    bs, w = plan.bs, plan.w
    rng = np.random.default_rng(1)
    B = 3
    r32 = lambda *s: rng.normal(size=s).astype(np.float32)
    Sinv = r32(B, ph, bs, bs) * 0.1 + np.eye(bs, dtype=np.float32)
    L = 0.3 * r32(B, ph - 1, bs, bs)
    X = 0.3 * r32(B, ph, bs, w)
    Gi = r32(B, w, w) * 0.1 + np.eye(w, dtype=np.float32)
    args = (Sinv, L, X, Gi, r32(B, ph, bs), r32(B, w))
    ker = jts.batched_sweep_solve(*(jnp.asarray(a) for a in args), interpret=True)
    twin = tts.batched_sweep_solve(*(torch.as_tensor(a) for a in args))
    scale = float(np.abs(np.asarray(ker[0])).max()) + 1.0
    for got, want in zip(twin, ker):
        assert got.dtype == torch.float32
        assert np.abs(got.numpy() - np.asarray(want)).max() / scale < 1e-5


# (ph, bs_p, nx, w) at the edges of the factor kernel's tiles: a stage block
# just past 32 (bs = 33), one primal slot, a border wider than the block, the
# Van der Pol shape, and the largest float64 shape the kernel's gate admits at
# the oscillators' proportions (chip_smoke.K4_LARGEST_F64)
EDGE_SHAPES = [(3, 20, 13, 9), (4, 1, 1, 3), (3, 1, 4, 3), (3, 5, 3, 12), (10, 3, 2, 3),
               chip_smoke.K4_LARGEST_F64[1:]]


@pytest.mark.parametrize("ph,bs_p,nx,w", EDGE_SHAPES)
def test_factor_twin_matches_the_sequential_recursion_at_the_kernel_edges(ph, bs_p, nx, w):
    """``traj_factor_plain`` (the reference the CUDA kernel is held against
    at these shapes on the card) against the JAX package's
    ``_traj_factor_seq``, float64, 1e-12 of scale: Sinv, X and the border
    Schur complement's inverse."""
    bs = bs_p + nx
    plan = SimpleNamespace(ph=ph, bs=bs, bs_p=bs_p, w=w)
    blocks = chip_smoke.traj_blocks(2, ph, bs_p, nx, w, seed=ph * 100 + bs)
    jf = jax.vmap(lambda d, l, c, g: jtk._traj_factor_seq(plan, d, l, c, g))(
        *(jnp.asarray(a) for a in blocks))
    tf = ttk.traj_factor(plan, *(torch.as_tensor(a) for a in blocks))
    for got, want in ((tf.Sinv, jf.Sinv), (tf.X, jf.X), (tf.Ghat_inv, jf.Ghat_inv)):
        want = np.asarray(want)
        assert got.shape == want.shape and got.dtype == torch.float64
        assert np.abs(got.numpy() - want).max() <= 1e-12 * max(1.0, np.abs(want).max())


_F32, _F64 = torch.float32, torch.float64


@pytest.mark.parametrize("ph,bs,bs_p,w,dtype,admitted", [
    (20, 30, 18, 8, _F32, True),    # the oscillators, float32
    (20, 30, 18, 8, _F64, True),    # and float64 (the golden, riccati against pdip)
    (10, 5, 3, 3, _F64, True),      # Van der Pol through the banded engine, float64
    (4, 72, 48, 8, _F64, True),     # the largest float64 block at those proportions
    (4, 73, 49, 8, _F64, False),    # the first refused
])
def test_factor_gate(ph, bs, bs_p, w, dtype, admitted):
    """The factor kernel's gate is its shared-memory layout
    (``csrc/traj_factor.cu::factor_layout``) against one block's limit."""
    assert tts.factor_supported(ph, bs, bs_p, w, dtype) is admitted
    assert (tts.factor_smem_bytes(bs, bs_p, w, dtype) <= tts.SMEM_LIMIT_BYTES) is admitted


@pytest.mark.parametrize("ph,bs,w,dtype,smem,admitted", [
    # the oscillators: two stage buffers of S^-1, L (900 words each) and X
    # (240), the 20 running vectors (600) and four work vectors (32 + 32 + 8 + 8
    # float32, 30 + 30 + 8 + 8 float64: each piece rounded to 16 bytes)
    (20, 30, 8, _F32, 4 * (2 * (900 + 900 + 240) + 600 + 80), True),
    (20, 30, 8, _F64, 8 * (2 * (900 + 900 + 240) + 600 + 76), True),
    (4, 72, 8, _F64, 178688, True),  # the largest float64 block K4 takes
    (20, 400, 8, _F32, 4 * (2 * (2 * 160000 + 3200) + 8000 + 816), False),
])
def test_sweep_gate(ph, bs, w, dtype, smem, admitted):
    """The sweep kernel's gate is its shared-memory layout
    (``csrc/traj_sweep.cu::sweep_layout``, one instance) against one block's
    limit."""
    assert tts.sweep_smem_bytes(ph, bs, w, dtype) == smem
    assert tts.sweeps_supported(ph, bs, w, dtype) is admitted


def test_gates_and_devices():
    """The kernels' gates are shared-memory gates of the card; a tensor that
    is neither on the CPU nor on a CUDA device never reaches a twin."""
    assert tts.factor_supported(20, 30, 18, 8) and tts.sweeps_supported(20, 30, 8)
    assert tts.factor_supported(20, 30, 18, 8, torch.float64)
    assert tts.factor_supported(1, 5, 3, 3) and tts.sweeps_supported(1, 5, 3)
    # float32 at the oscillators' shape: Sp and LS (30 x 36 each), two [S|Z]
    # and one [L'|Z] (30 x 44 each), the border sum and the pivot
    # reciprocals (64 + 36), four tail rows of 44
    assert tts.factor_smem_bytes(30, 18, 8) == 4 * (
        2 * 30 * 36 + 3 * 30 * 44 + 100 + 4 * 44)
    assert tts.factor_smem_bytes(30, 18, 8) == 25584
    assert tts.factor_smem_bytes(30, 18, 8, torch.float64) == 48704
    assert not tts.factor_supported(20, 300, 200, 8)
    assert not tts.factor_supported(20, 30, 30, 8) and not tts.factor_supported(0, 30, 18, 8)
    assert not tts.sweeps_supported(20, 400, 8)
    z = lambda *s: torch.empty(s, device="meta")
    lf, ls = tts.batched_factor.launches, tts.batched_sweep_solve.launches
    with pytest.raises(ValueError, match="unsupported device"):
        tts.batched_factor(z(2, 3, 5, 5), z(2, 2, 5, 5), z(2, 3, 5, 3), z(2, 3, 3), 3)
    with pytest.raises(ValueError, match="unsupported device"):
        tts.batched_sweep_solve(z(2, 3, 5, 5), z(2, 2, 5, 5), z(2, 3, 5, 3), z(2, 3, 3),
                                z(2, 3, 5), z(2, 3))
    assert (tts.batched_factor.launches, tts.batched_sweep_solve.launches) == (lf, ls)
