"""K2's twin (the CPU path of ``chol_inverse``) against the Pallas kernel
``batched_linalg._chol_inverse_pallas`` run in interpret mode and against
the JAX package's float64 ``chol_inverse``; K2's layout (``layout``, the one
owner of the tier and lanes a matrix); a numpy emulation of the CUDA
kernel's order of operations held against the twin; and the batch-first SPD
helpers of the port."""

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


@pytest.mark.parametrize("B,k", [(37, 24), (5, 17), (130, 24), (5, 8), (5, 20)])
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


def test_twin_float64_matches_jax_chol_inverse_at_the_ugv_width():
    """k = 61, the UGV's per-instance KKT inverse (the block tier's width):
    the JAX package's float64 ``chol_inverse`` (XLA Cholesky and triangular
    solves) against the twin."""
    C = _spd_batch(3, 61, seed=61, dtype=np.float64)
    want = np.asarray(jbl.chol_inverse(jnp.asarray(C)))
    got = tbl.chol_inverse(torch.as_tensor(C)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())


# -- the layout -------------------------------------------------------------------

F32, F64 = torch.float32, torch.float64


@pytest.mark.parametrize("k,dtype,tier,g,kp", [
    (1, F32, tbl.TIER_REGISTER, 1, 4), (8, F32, tbl.TIER_REGISTER, 2, 8),
    (8, F64, tbl.TIER_REGISTER, 2, 8), (20, F32, tbl.TIER_REGISTER, 4, 20),
    (20, F64, tbl.TIER_REGISTER, 4, 20), (24, F32, tbl.TIER_REGISTER, 8, 24),
    (24, F64, tbl.TIER_REGISTER, 8, 24), (32, F32, tbl.TIER_REGISTER, 8, 32),
    (32, F64, tbl.TIER_REGISTER, 16, 32), (33, F32, tbl.TIER_BLOCK, 0, 33),
    (48, F64, tbl.TIER_BLOCK, 0, 48), (61, F32, tbl.TIER_BLOCK, 0, 61),
    (64, F64, tbl.TIER_BLOCK, 0, 64)])
def test_layout_tier_and_lanes_by_k_and_dtype(k, dtype, tier, g, kp):
    lay = tbl.layout(16384, k, dtype)
    assert (lay.tier, lay.g, lay.kp) == (tier, g, kp)
    if tier == tbl.TIER_REGISTER:
        assert lay.grid == -(-16384 // (lay.threads // g))
    else:
        assert (lay.threads, lay.grid) == (tbl.BLOCK_THREADS, 16384)


@pytest.mark.parametrize("k,dtype,smem", [
    (8, F32, 0), (8, F64, 0), (20, F32, 53760), (20, F64, 103424), (24, F32, 37376),
    (24, F64, 74752), (48, F32, 19200), (48, F64, 38400), (61, F32, 30256), (61, F64, 60512)])
def test_layout_shared_memory_at_the_path_shapes(k, dtype, smem):
    """At B = 16384 a register-tier block (128 threads) stages its output,
    32 / g matrices a warp, k^2 elements and a pad apart (420 / 404 and 584
    elements), except at k = 8, whose batch of 1 MiB and less of output
    goes out unstaged at B = 1024 (the oscillators' border); the block tier
    holds the matrix and (L^-1)' with odd rows and 2 k pivot reciprocals."""
    B = 1024 if k == 8 else 16384
    lay = tbl.layout(B, k, dtype)
    assert lay.smem_bytes == smem
    if lay.tier == tbl.TIER_REGISTER:
        elem = 4 if dtype == F32 else 8
        assert lay.stage == int(B * k * k * elem >= tbl.STAGE_MIN_BYTES)
        if lay.stage:
            assert lay.threads == 128
            assert lay.smem_bytes == (128 // lay.g) * tbl.stage_stride(k, lay.g, dtype) * (
                4 if dtype == F32 else 8)
            assert tbl.stage_stride(k, lay.g, dtype) == {20: 420 if dtype == F32 else 404,
                                                         24: 584}[k]


@pytest.mark.parametrize("dtype", [F32, F64])
def test_layout_choices_are_instances_within_the_register_budget(dtype):
    """Every k <= 32 has an instance within the register budget: the most
    lanes (at most 8, 32 elements of the matrix a lane at least) dividing k
    rounded up to 4, or, where that share does not fit (k > 24 in both
    types), the fewest lanes that fit the padded matrix."""
    for k in range(1, tbl.REG_MAX_K + 1):
        lay = tbl.layout(1000, k, dtype)
        assert (lay.kp, lay.g) in tbl.REG_INSTANCES[dtype], k
        assert lay.kp >= k and lay.kp % max(4, lay.g) == 0
        assert tbl.register_words(lay.kp, lay.g, dtype) <= tbl.REG_WORDS[dtype]
        kp4 = -(-k // 4) * 4
        if k <= 24:
            assert lay.kp == kp4 and (lay.g == 1 or kp4 * kp4 >= 32 * lay.g)
            more = 2 * lay.g
            assert (more > 8 or kp4 * kp4 < 32 * more or kp4 % more != 0
                    or tbl.register_words(kp4, more, dtype) > tbl.REG_WORDS[dtype]), k
        else:
            assert (lay.kp, lay.g) == ((32, 8) if dtype == F32 else (32, 16))
    assert [tbl.layout(1000, k, dtype).g for k in (4, 8, 12, 16, 20, 24)] == [1, 2, 4, 8, 4, 8]
    # the library holds the layout's choices and no instance besides
    chosen = {(tbl.layout(1000, k, dtype).kp, tbl.layout(1000, k, dtype).g)
              for k in range(1, tbl.REG_MAX_K + 1)}
    assert chosen == tbl.REG_INSTANCES[dtype]


def test_layout_threads_by_batch_and_forced_layouts():
    assert tbl.layout(1024, 8, F32).threads == 32  # 64 warps: one a block
    assert tbl.layout(16384, 24, F32).threads == 128
    lay = tbl.register_layout(1024, 8, F32)
    assert (lay.g, lay.kp, lay.grid, lay.stage, lay.smem_bytes) == (2, 8, 64, 0, 0)
    lay = tbl.register_layout(1024, 8, F32, stage=True)
    assert (lay.stage, lay.smem_bytes) == (1, 16 * 64 * 4)  # no pad puts k^2 2 banks on
    lay = tbl.register_layout(1024, 20, F32, g=8)  # the (24, 8) instance
    assert (lay.g, lay.kp, lay.grid) == (8, 24, 256)
    assert tbl.register_layout(1024, 8, F32, g=1) is None  # no such instance
    assert tbl.register_layout(1024, 8, F32, g=4) is None
    assert tbl.layout(4096, 8, F32).stage == 1  # 1 MiB of output
    assert tbl.register_layout(100, 20, F64, g=2) is None  # no such instance
    assert tbl.register_layout(100, 33, F32) is None
    assert tbl.block_layout(37, 24, F32) == tbl.Layout(tbl.TIER_BLOCK, 0, 24, 128, 37, 0, 4992)


@pytest.mark.parametrize("k", [0, 65])
def test_layout_refuses_k_past_the_kernel(k):
    with pytest.raises(ValueError, match="k <= 64"):
        tbl.layout(16, k, F32)


def test_cpu_tensors_never_consult_the_layout(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("the layout was consulted for a CPU tensor")
    monkeypatch.setattr(tbl, "layout", refuse)
    launches = tbl.chol_inverse.launches
    C = torch.as_tensor(_spd_batch(4, 24, seed=3))
    np.testing.assert_allclose(tbl.chol_inverse(C).numpy(), np.linalg.inv(C.numpy()),
                               rtol=0, atol=1e-4)
    assert tbl.chol_inverse.launches == launches


@pytest.mark.parametrize("B,k,elem", [(1, 1, 4), (3, 8, 4), (5, 20, 4), (4, 24, 4),
                                       (3, 24, 8), (7, 61, 4), (2, 61, 8)])
def test_k2_bound_reads_the_lower_triangles_by_sector(B, k, elem):
    """``chip_smoke.k2_bound_ms`` counts the input as the 32-byte sectors
    that hold the lower triangles of the batch (a set of sector indices
    here), and the whole output."""
    import chip_smoke

    r, c = np.tril_indices(k)
    at = np.arange(B)[:, None] * k * k + (r * k + c)[None, :]
    want = len(np.unique(at * elem // 32)) * 32
    assert chip_smoke.lower_triangle_bytes(B, k, elem) == want
    if (B, k, elem) == (4, 24, 4):
        assert want == 4 * 384 * 4  # rows 0-7 one sector, 8-15 two, 16-23 three
    ms, by = chip_smoke.k2_bound_ms(B, k, elem)
    assert by == "bytes"
    assert ms == pytest.approx(1e3 * (want + B * k * k * elem) / chip_smoke.PEAK_BYTES)


# -- the kernel's order of operations, emulated in numpy -------------------------

def _emulate_register_tier(C, kp, g):
    """``csrc/chol_inverse.cu``'s register tier step by step in float64: rows
    i of a kp x kp lower triangle (the identity past k) held as slot
    i // g with positions [0, (i // g + 1) g), values past the diagonal
    computed where the kernel computes them; in place, (1) the Cholesky
    factor with 1 / L(p, p) on the diagonal, then one pass whose step q
    broadcasts the finished row q of T = L^-1 scaled by the rows' L(i, i)
    for (2) the rows below q, which go on forming T, and (3) the rows above
    q, which add its term to X's lower triangle, row q starting its own."""
    B, k, _ = C.shape
    W = [(i // g + 1) * g for i in range(kp)]
    a = np.zeros((B, kp, kp))
    for i in range(kp):
        for j in range(W[i]):
            a[:, i, j] = C[:, i, j] if i < k and j < k else float(i == j)
    zero = np.zeros(B)
    for p in range(kp):  # 1. Cholesky
        d = a[:, p, p].copy()
        inv = 1.0 / np.sqrt(np.where(np.isnan(d), d, np.maximum(d, 1e-30)))
        rd = 1.0 / (d * inv)
        col = a[:, :, p].copy()
        for i in range(kp):
            if W[i] - 1 < p:
                continue
            raw = a[:, i, p].copy()
            c = raw * inv * inv if i > p else zero
            a[:, i, p] = raw * inv if i > p else (rd if i == p else raw)
            for j in range(p + 1, W[i]):
                a[:, i, j] -= c * col[:, j]
    for q in range(kp):  # 2 and 3 in one pass: row q of T, final, serves both
        rd, tr = a[:, q, q].copy(), a[:, q, :q].copy()
        r2 = rd * rd
        for i in range(kp):
            if i > q:  # 2. T in place of L
                c = a[:, i, q] * rd
                a[:, i, :q] -= c[:, None] * tr
                a[:, i, q] = -c
            elif i < q:  # 3. X in place of T, the positions up to min(width, q)
                w = min(W[i], q)
                a[:, i, :w] += (r2 * tr[:, i])[:, None] * tr[:, :w]
            else:
                a[:, q, :q] = r2[:, None] * tr
                a[:, q, q] = r2
    X = np.tril(a[:, :k, :k])
    return X + np.transpose(np.tril(X, -1), (0, 2, 1))


def _emulate_block_tier(C):
    """The block tier: the right-looking factor with the 1e-30 pivot floor,
    Yt = (L^-1)' by rows of L^-1, then X = Yt Yt'."""
    B, k, _ = C.shape
    A = C.copy()
    L = np.zeros_like(C)
    for p in range(k):
        d = A[:, p, p]
        inv = 1.0 / np.sqrt(np.where(np.isnan(d), d, np.maximum(d, 1e-30)))
        L[:, p:, p] = A[:, p:, p] * inv[:, None]
        A[:, p + 1:, p + 1:] -= L[:, p + 1:, p, None] * L[:, None, p + 1:, p]
    Y = np.zeros_like(C)
    for i in range(k):
        Y[:, i, :] = -np.einsum("bm,bmj->bj", L[:, i, :i], Y[:, :i, :])
        Y[:, i, i] += 1.0
        Y[:, i, :] /= L[:, i, i, None]
    Yt = np.transpose(Y, (0, 2, 1))
    return Yt @ np.transpose(Yt, (0, 2, 1))


@pytest.mark.parametrize("k", [1, 8, 24, 32, 33, 61, 64])
def test_kernel_order_of_operations_matches_the_twin(k):
    """The emulated kernel against the twin, float64, 1e-12: for k <= 32 at
    the register layouts both types choose (their padded size and lanes a
    matrix), and every k in the block tier's order."""
    C = _spd_batch(3, k, seed=100 + k, dtype=np.float64)
    want = tbl.chol_inverse_plain(torch.as_tensor(C)).numpy()
    scale = np.abs(want).max()
    if k <= tbl.REG_MAX_K:
        for dtype in (F32, F64):
            lay = tbl.layout(3, k, dtype)
            got = _emulate_register_tier(C, lay.kp, lay.g)
            assert np.abs(got - want).max() <= 1e-12 * scale, (dtype, lay)
    got = _emulate_block_tier(C)
    assert np.abs(got - want).max() <= 1e-12 * scale
