"""The five CUDA kernels against their plain twins, on the card.

These tests need a CUDA device and nvcc; without them they skip.  They
import neither JAX nor the JAX package, so on a machine without JAX run
them without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the repository root's smoke script; imports no JAX)
from libmpc_tpu_torch.ops import _host, admm_fused, batched_linalg, qp_inner_fused
from libmpc_tpu_torch.ops import trajectory_sweeps as tsw

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


def _k1_against_twin(device, B, n, m, dtype, frozen=3, seed=0, lay=None):
    """K1 (at ``lay``, or at the layout's own choice for None) and its twin,
    10 iterations from a nonzero state (two twin iterations from the
    origin), lane ``frozen`` frozen (None: none).  Returns the worst error
    relative to the twin's scale, whether the frozen lane kept x/z/y
    bitwise, and the layout the launch used."""
    refine = dtype == torch.float32
    q, l, u, A, M, Minv, rho = _k1_data(B, n, m, dtype, device, seed)
    zeros = lambda w: torch.zeros((B, w), dtype=dtype, device=device)
    done = torch.zeros(B, dtype=torch.bool, device=device)
    kw = dict(sigma=1e-5, alpha=1.6, refine=refine)
    x, z, y = admm_fused.plain_iterations(zeros(n), zeros(m), zeros(m), done,
                                          q, l, u, A, M, Minv, rho, k_iters=2, **kw)
    if frozen is not None:
        done[frozen] = True
    admm_fused.fused_iterations.trace = []
    try:
        args = (x, z, y, done, q, l, u, A, M, Minv, rho)
        got = (admm_fused.fused_iterations(*args, k_iters=10, **kw) if lay is None
               else admm_fused.launch(lay, *args, k_iters=10, **kw))
        (_, lay), = admm_fused.fused_iterations.trace
    finally:
        admm_fused.fused_iterations.trace = None
    want = admm_fused.plain_iterations(x, z, y, done, q, l, u, A, M, Minv, rho,
                                       k_iters=10, **kw)
    torch.cuda.synchronize()
    rel = max(((g - w).abs().max() / w.abs().max()).item() for g, w in zip(got, want))
    kept = frozen is None or all(torch.equal(g[frozen], s[frozen])
                                 for g, s in zip(got, (x, z, y)))
    return rel, kept, lay


_K1_TOL = {torch.float32: 1e-4, torch.float64: 1e-10}


@pytest.mark.parametrize("dtype,tier", [(torch.float32, None), (torch.float32, 1),
                                        (torch.float32, 0), (torch.float64, None)])
@pytest.mark.parametrize("B,frozen", [(1024, 3), (1003, 3), (37, 3), (1, 0), (1, None)])
def test_fused_iterations_at_the_quadrotor_shape(cuda, dtype, B, frozen, tier):
    """The layout's own choice, then, in float32, each tier forced (the
    staged tier at the tile its cost model picks)."""
    lay = {None: None, 1: admm_fused.staged_layout(B, 216, 535),
           0: admm_fused.stream_layout(B, 216, 535, dtype)}[tier]
    rel, kept, ran = _k1_against_twin(cuda, B, 216, 535, dtype, frozen, lay=lay)
    assert ran == (lay or admm_fused.layout(B, 216, 535, dtype))
    assert rel <= _K1_TOL[dtype] and kept


@pytest.mark.parametrize("bt", [16, 8, 4])
@pytest.mark.parametrize("stages", [2, 3, 4])
def test_fused_iterations_every_staged_tile(cuda, bt, stages):
    """Each tile and ring depth forced at B=61: no multiple of any tile, so
    every tile's last block is ragged."""
    dtype = torch.float32
    lay = admm_fused.staged_layout(61, 24, 40, bt, stages)
    assert (lay.tier, lay.bt, lay.stages) == (1, bt, stages)
    rel, kept, _ = _k1_against_twin(cuda, 61, 24, 40, dtype, lay=lay)
    assert rel <= _K1_TOL[dtype] and kept


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,m", [(13, 40), (260, 30)])
def test_fused_iterations_stream_tier(cuda, dtype, n, m):
    """Rows that are not a multiple of 16 bytes (n = 13) and n past the
    staged tier's 256 run the stream tier (as float64 always does)."""
    rel, kept, lay = _k1_against_twin(cuda, 37, n, m, dtype)
    assert lay.tier == 0
    assert rel <= _K1_TOL[dtype] and kept


def test_fused_iterations_misaligned_matrices_run_the_stream_tier(cuda):
    q, l, u, A, M, Minv, rho = _k1_data(37, 24, 40, torch.float32, cuda)
    A2 = torch.empty(A.numel() + 1, dtype=A.dtype, device=cuda)[1:].view_as(A)
    A2.copy_(A)
    assert A2.data_ptr() % 16 != 0 and A2.is_contiguous()
    x = torch.zeros((37, 24), device=cuda)
    z = torch.zeros((37, 40), device=cuda)
    done = torch.zeros(37, dtype=torch.bool, device=cuda)
    kw = dict(sigma=1e-5, alpha=1.6, k_iters=10, refine=True)
    admm_fused.fused_iterations.trace = []
    try:
        got = admm_fused.fused_iterations(x, z, z, done, q, l, u, A2, M, Minv, rho, **kw)
        (_, lay), = admm_fused.fused_iterations.trace
    finally:
        admm_fused.fused_iterations.trace = None
    want = admm_fused.plain_iterations(x, z, z, done, q, l, u, A, M, Minv, rho, **kw)
    assert lay.tier == 0
    for g, w in zip(got, want):
        assert (g - w).abs().max().item() <= 1e-4 * w.abs().max().item()


@pytest.mark.parametrize("dtype,n,m,tier,bt,stages,misaligned", [
    (torch.float32, 13, 40, 1, 8, 2, False),    # 52-byte rows
    (torch.float64, 24, 40, 1, 4, 2, False),    # the staged tier is float32 only
    (torch.float32, 260, 30, 1, 4, 2, False),   # past 256 columns
    (torch.float32, 24, 40, 1, 8, 2, True),     # A not 16-byte aligned
    (torch.float32, 24, 40, 1, 12, 2, False),   # no such tile
    (torch.float32, 24, 40, 1, 8, 5, False),    # more stages than the ring has
    (torch.float32, 24, 40, 1, 8, 1, False),
    (torch.float32, 216, 535, 1, 16, 5, False),
    (torch.float32, 216, 535, 0, 16, 0, False),  # stream tiles: 8 lanes at most
    (torch.float64, 216, 535, 0, 8, 0, False),   # 4 in float64
    (torch.float32, 216, 535, 0, 8, 2, False),   # no ring in the stream tier
    (torch.float32, 2000, 5000, 0, 4, 0, False),  # past the shared memory
])
def test_fused_iterations_launcher_checks_the_layout(cuda, dtype, n, m, tier, bt, stages,
                                                     misaligned):
    """The caller (``admm_fused.layout``) owns the choice of layout; the
    launcher refuses one that does not apply to the shape or does not fit
    the shared memory, and counts no launch."""
    B = 37
    q, l, u, A, M, Minv, rho = _k1_data(B, n, m, dtype, cuda)
    if misaligned:
        A2 = torch.empty(A.numel() + 1, dtype=dtype, device=cuda)[1:].view_as(A)
        A = A2.copy_(A)
    zeros = lambda w: torch.zeros((B, w), dtype=dtype, device=cuda)
    done = torch.zeros(B, dtype=torch.bool, device=cuda)
    lay = admm_fused.Layout(tier, bt, 16 * bt if tier else 384, 0, -(-B // bt), stages)
    launches = admm_fused.fused_iterations.launches
    with pytest.raises(RuntimeError, match="invalid argument"):
        admm_fused.launch(lay, zeros(n), zeros(m), zeros(m), done, q, l, u, A, M, Minv, rho,
                          sigma=1e-5, alpha=1.6, k_iters=10, refine=True)
    assert admm_fused.fused_iterations.launches == launches


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


_K2_TOL = {torch.float32: 1e-4, torch.float64: 1e-10}
_K2_RESID = {torch.float32: 1e-3, torch.float64: 1e-8}


def _k2_spd(B, k, dtype, device, seed=0):
    return torch.as_tensor(chip_smoke.spd_batch(B, k, seed), dtype=dtype, device=device)


def _k2_layouts(B, k, dtype):
    """The layout's choice, then every other layout that applies: the block
    tier and each register instance for k <= 32, staged and not."""
    lays = [batched_linalg.layout(B, k, dtype)]
    if k <= batched_linalg.REG_MAX_K:
        for g in (1, 2, 4, 8, 16):
            for stage in (False, True):
                lay = batched_linalg.register_layout(B, k, dtype, g=g, stage=stage)
                if lay is not None and lay not in lays:
                    lays.append(lay)
        lays.append(batched_linalg.block_layout(B, k, dtype))
    return lays


def _k2_check(C, got, dtype, what):
    want = batched_linalg.chol_inverse_plain(C)
    k = C.shape[-1]
    eye = torch.eye(k, dtype=torch.float64, device=C.device)
    rel = (got - want).abs().max().item() / want.abs().max().item()
    resid = (C.double() @ got.double() - eye).abs().max().item()
    assert rel <= _K2_TOL[dtype], (what, rel)
    assert resid <= _K2_RESID[dtype], (what, resid)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_chol_inverse_every_k_and_every_layout(cuda, dtype):
    """Every k from 1 to 64 on a ragged batch of 37, at the layout's choice
    and with each other layout that applies forced (the block tier and the
    other register instances for k <= 32)."""
    for k in range(1, batched_linalg.MAX_K + 1):
        C = _k2_spd(37, k, dtype, cuda, seed=k)
        for lay in _k2_layouts(37, k, dtype):
            got = batched_linalg.launch(lay, C)
            torch.cuda.synchronize()
            _k2_check(C, got, dtype, (k, lay))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k", [8, 20, 24, 48, 61])
@pytest.mark.parametrize("B", [1, 3, 37, 1001, "blocks"])
def test_chol_inverse_batches(cuda, dtype, k, B):
    """Batches of 1, 3, 37, 1001 and a whole number of blocks (eight blocks
    of the register tier's 128 threads; 64 matrices in the block tier)."""
    if B == "blocks":
        lay = batched_linalg.layout(4096, k, dtype)
        B = 8 * (lay.threads // lay.g) if lay.tier == batched_linalg.TIER_REGISTER else 64
    C = _k2_spd(B, k, dtype, cuda, seed=B + k)
    launches = batched_linalg.chol_inverse.launches
    got = batched_linalg.chol_inverse(C)
    torch.cuda.synchronize()
    assert batched_linalg.chol_inverse.launches == launches + 1
    _k2_check(C, got, dtype, (B, k))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k", [4, 8, 20, 24, 32, 61])
def test_chol_inverse_unaligned_input_takes_the_scalar_path(cuda, dtype, k):
    """C one element into a larger buffer (its rows no longer 16-byte
    aligned): the element-by-element path, at every layout that applies."""
    C = chip_smoke.unaligned_copy(torch, _k2_spd(37, k, dtype, cuda, seed=k), offset=1)
    assert C.data_ptr() % 16 != 0 and C.is_contiguous()
    for lay in _k2_layouts(37, k, dtype):
        got = batched_linalg.launch(lay, C)
        torch.cuda.synchronize()
        _k2_check(C, got, dtype, lay)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k", [8, 20, 24, 48, 61])
def test_chol_inverse_nan_lane_stays_apart(cuda, dtype, k):
    """A NaN pivot and a symmetric NaN pair below it: those two matrices
    come back NaN; the others equal a run without them bitwise."""
    C = _k2_spd(37, k, dtype, cuda, seed=7)
    bad = C.clone()
    bad[5, 2, 2] = float("nan")
    bad[9, 3, 1] = bad[9, 1, 3] = float("nan")
    keep = [b for b in range(37) if b not in (5, 9)]
    for lay in _k2_layouts(37, k, dtype):
        clean = batched_linalg.launch(lay, C)
        got = batched_linalg.launch(lay, bad)
        torch.cuda.synchronize()
        assert torch.isnan(got[5]).all() and torch.isnan(got[9]).all(), lay
        assert torch.equal(got[keep], clean[keep]), lay


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_chol_inverse_launcher_refuses_a_layout_that_does_not_apply(cuda, dtype):
    L, R, BL = batched_linalg.Layout, batched_linalg.TIER_REGISTER, batched_linalg.TIER_BLOCK
    C24 = _k2_spd(5, 24, dtype, cuda)
    C40 = _k2_spd(5, 40, dtype, cuda)
    refused = [(C40, L(R, 8, 40, 128, 1, 0, 0)),  # the register tier takes k <= 32
               (C24, L(R, 3, 24, 96, 1, 0, 0)),  # g not a power of two
               (C24, L(R, 2, 24, 128, 1, 0, 0)),  # no (24, 2) instance
               (C24, L(R, 4, 24, 128, 1, 0, 0)),  # no (24, 4) instance either
               (C24, L(R, 8, 24, 256, 1, 0, 0)),  # over 128 threads
               (C24, L(R, 8, 24, 48, 1, 0, 0)),  # not whole warps
               (C24, L(R, 8, 24, 128, 1, 2, 0)),  # stage is 0 or 1
               (C24, L(BL, 4, 24, 128, 5, 0, 0)),  # the block tier takes g = 0
               (C24, L(BL, 0, 24, 128, 5, 1, 0)),  # and stages nothing
               (C24, L(BL, 0, 24, 32, 5, 0, 0)),  # one warp cannot pipeline its pivots
               (C24, L(2, 0, 24, 128, 5, 0, 0))]  # no such tier
    launches = batched_linalg.chol_inverse.launches
    for C, lay in refused:
        with pytest.raises(RuntimeError, match="invalid argument"):
            batched_linalg.launch(lay, C)
    assert batched_linalg.chol_inverse.launches == launches
    empty = batched_linalg.chol_inverse(torch.empty((0, 24, 24), dtype=dtype, device=cuda))
    assert empty.shape == (0, 24, 24) and batched_linalg.chol_inverse.launches == launches


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_chol_inverse_layout_rules_equal_the_librarys(cuda, dtype):
    """Python's layout rules (``register_layout``'s instances, padding,
    grid and ``stage_stride``; ``block_smem_bytes``) give what the library's
    own check gives (``libmpc_chol_inverse_plan``) for every k, lane count,
    thread count and staging, at several batches: a layout Python refuses
    the library refuses, and the other way round."""
    import ctypes

    from libmpc_tpu_torch.ops import _build

    plan = _build.library().libmpc_chol_inverse_plan
    out = (ctypes.c_longlong * 3)()
    f64 = int(dtype == torch.float64)

    def library(B, k, tier, g, threads, stage):
        code = plan(f64, B, k, tier, g, threads, stage, ctypes.addressof(out))
        return None if code != 0 else (out[0], out[1], out[2])

    for B in (1, 37, 1001, 16384):
        for k in range(1, batched_linalg.MAX_K + 1):
            for g in (1, 2, 4, 8, 16, 32):
                for threads in (32, 64, 128):
                    for stage in (False, True):
                        lay = (batched_linalg.register_layout(B, k, dtype, g=g, threads=threads,
                                                              stage=stage)
                               if k <= batched_linalg.REG_MAX_K else None)
                        want = None if lay is None else (lay.kp, lay.grid, lay.smem_bytes)
                        got = library(B, k, batched_linalg.TIER_REGISTER, g, threads, int(stage))
                        assert got == want, (B, k, g, threads, stage)
            for threads in (64, 128, 256):
                lay = batched_linalg.block_layout(B, k, dtype, threads=threads)
                got = library(B, k, batched_linalg.TIER_BLOCK, 0, threads, 0)
                assert got == (lay.kp, lay.grid, lay.smem_bytes), (B, k, threads)


def test_kernels_refuse_what_they_do_not_take(cuda):
    with pytest.raises(ValueError, match="k <= 64"):
        batched_linalg.chol_inverse(torch.eye(65, device=cuda).expand(2, 65, 65).contiguous())
    with pytest.raises(TypeError):
        batched_linalg.chol_inverse(torch.eye(4, dtype=torch.float16, device=cuda)[None])


def _k3_data(B, dtype, device, seed=0, n=26, me=20, mi=11, box=True):
    """Feasible QPs of the SQP's form: equality rows, one-sided rows with
    -inf, (``box``) identity box rows of which some are infinite; a mild
    equality penalty so that float32 rounding is not amplified.  The
    generator of ``chip_smoke.k3_qps`` (one copy serves the smoke run and
    these tests)."""
    return [torch.as_tensor(a, dtype=dtype, device=device)
            for a in chip_smoke.k3_qps(B, seed, n, me, mi, box)]


_K3_KW = dict(sigma=1e-5, alpha=1.6, max_iter=300, check_every=25)


@pytest.mark.parametrize("B", [64, 37])
def test_qp_inner_kernel_matches_twin_float64(cuda, B):
    """float64 at tight tolerances: ``done`` and the iteration count equal on
    every lane (ragged batch included), x/y/z within 1e-10 of scale."""
    data = _k3_data(B, torch.float64, cuda)
    x0 = torch.zeros((B, 26), dtype=torch.float64, device=cuda)
    y0 = torch.zeros((B, 57), dtype=torch.float64, device=cuda)
    kw = dict(_K3_KW, eps_abs=1e-9, eps_rel=1e-9, max_iter=2000)
    launches = qp_inner_fused.solve_batched.launches
    got = qp_inner_fused.solve_batched(*data, x0, y0, **kw)
    want = qp_inner_fused.plain_solve_batched(*data, x0, y0, **kw)
    torch.cuda.synchronize()
    assert qp_inner_fused.solve_batched.launches == launches + 1
    assert torch.equal(got[4], want[4]) and got[4].all()
    assert torch.equal(got[3], want[3]) and got[3].dtype == torch.int32
    for g, w in zip(got[:3], want[:3]):
        assert (g - w).abs().max().item() <= 1e-10 * max(1.0, w.abs().max().item())


def test_qp_inner_kernel_matches_twin_float32(cuda):
    """float32 at the path's tolerance (5e-6): x and z within 1e-3 of scale
    on every lane; ``done`` is compared as a fraction because float32 lanes
    at the threshold may stop a check block apart."""
    B = 64
    data = _k3_data(B, torch.float32, cuda, seed=1)
    x0 = torch.zeros((B, 26), device=cuda)
    y0 = torch.zeros((B, 57), device=cuda)
    kw = dict(_K3_KW, eps_abs=5e-6, eps_rel=5e-6)
    got = qp_inner_fused.solve_batched(*data, x0, y0, **kw)
    want = qp_inner_fused.plain_solve_batched(*data, x0, y0, **kw)
    torch.cuda.synchronize()
    for g, w in ((got[0], want[0]), (got[2], want[2])):
        assert (g - w).abs().max().item() <= 1e-3 * max(1.0, w.abs().max().item())
    assert (got[4] == want[4]).float().mean().item() >= 0.75


def test_qp_inner_warm_start_at_the_optimum_is_frozen_after_one_block(cuda):
    """A lane whose warm start is already optimal converges at the first
    check: 25 iterations, ``done``, and the solution unmoved."""
    B = 8
    data = _k3_data(B, torch.float64, cuda, seed=2)
    x0 = torch.zeros((B, 26), dtype=torch.float64, device=cuda)
    y0 = torch.zeros((B, 57), dtype=torch.float64, device=cuda)
    kw = dict(_K3_KW, eps_abs=1e-9, eps_rel=1e-9, max_iter=4000)
    x, y, *_ = qp_inner_fused.solve_batched(*data, x0, y0, **kw)
    loose = dict(kw, eps_abs=1e-6, eps_rel=1e-6)
    x2, y2, z2, iters, done, pri, dua = qp_inner_fused.solve_batched(*data, x, y, **loose)
    torch.cuda.synchronize()
    assert done.all() and (iters == 25).all()
    assert (x2 - x).abs().max().item() <= 1e-6


# (B, n, me, mi, box, tier): both sides of the register tier's bound (n <= 32,
# m <= 64), two shapes on the JAX package's fused gate's frontier (the
# largest m at n = 12; the largest n, with m = 1) and a ragged batch
_K3_TIER_CASES = [(64, 32, 20, 12, True, "register"), (64, 32, 20, 13, True, "shared"),
                  (64, 33, 20, 11, True, "shared"), (37, 12, 6, 361, True, "shared"),
                  (64, 56, 0, 1, False, "shared"), (1003, 26, 20, 11, True, "register"),
                  (1, 26, 20, 11, True, "register")]


def _twin_spread(data, x0, y0, kw):
    """How far two correct evaluations of the same QPs part: the twin
    against the twin on the constraint rows in another order (the same
    problem, other rounding), as a fraction of scale for x, y and z."""
    P, A, q, l, u, rho = data
    m = A.shape[1]
    perm = torch.as_tensor(np.random.default_rng(0).permutation(m), device=A.device)
    inv = torch.argsort(perm)
    a = qp_inner_fused.plain_solve_batched(*data, x0, y0, **kw)
    b = qp_inner_fused.plain_solve_batched(P, A[:, perm], q, l[:, perm], u[:, perm],
                                           rho[:, perm], x0, y0[:, perm], **kw)
    return [(g - w).abs().max().item() / max(1.0, w.abs().max().item())
            for g, w in zip((b[0], b[1][:, inv], b[2][:, inv]), a[:3])]


@pytest.mark.parametrize("B,n,me,mi,box,tier", _K3_TIER_CASES)
def test_qp_inner_tiers_match_twin_float64(cuda, B, n, me, mi, box, tier):
    """Each tier against the twin in float64 at tight tolerances: ``done``
    and the iteration count equal on every lane, x/y/z within 1e-10 of
    scale, or within 3x the twin's own spread where the shape's
    conditioning parts two correct evaluations further (m = 379 rows on
    n = 12: 2e-10 in x, 2e-8 in y)."""
    data = _k3_data(B, torch.float64, cuda, seed=n + mi, n=n, me=me, mi=mi, box=box)
    m = data[1].shape[1]
    assert qp_inner_fused.tier(n, m) == tier and qp_inner_fused.supported(n, m, torch.float64)
    x0 = torch.zeros((B, n), dtype=torch.float64, device=cuda)
    y0 = torch.zeros((B, m), dtype=torch.float64, device=cuda)
    kw = dict(_K3_KW, eps_abs=1e-9, eps_rel=1e-9, max_iter=2000)
    launches = qp_inner_fused.solve_batched.launches
    got = qp_inner_fused.solve_batched(*data, x0, y0, **kw)
    want = qp_inner_fused.plain_solve_batched(*data, x0, y0, **kw)
    torch.cuda.synchronize()
    assert qp_inner_fused.solve_batched.launches == launches + 1
    assert torch.equal(got[4], want[4]) and torch.equal(got[3], want[3])
    spread = _twin_spread(data, x0, y0, kw)
    for g, w, sp in zip(got[:3], want[:3], spread):
        assert (g - w).abs().max().item() <= max(1e-10, 3 * sp) * max(1.0, w.abs().max().item())


@pytest.mark.parametrize("B,n,me,mi,box,tier", _K3_TIER_CASES)
def test_qp_inner_tiers_match_twin_float32(cuda, B, n, me, mi, box, tier):
    """Each tier in float32 at the path's tolerance (5e-6), held as
    ``test_qp_inner_kernel_matches_twin_float32`` holds the path's shape:
    x and z within 1e-3 of scale, or 3x the twin's own spread where that is
    larger (m = 379 on n = 12: 1.7e-3), and ``done`` equal on 3 lanes in 4."""
    data = _k3_data(B, torch.float32, cuda, seed=n + mi + 1, n=n, me=me, mi=mi, box=box)
    m = data[1].shape[1]
    assert qp_inner_fused.tier(n, m) == tier
    x0 = torch.zeros((B, n), device=cuda)
    y0 = torch.zeros((B, m), device=cuda)
    kw = dict(_K3_KW, eps_abs=5e-6, eps_rel=5e-6)
    got = qp_inner_fused.solve_batched(*data, x0, y0, **kw)
    want = qp_inner_fused.plain_solve_batched(*data, x0, y0, **kw)
    torch.cuda.synchronize()
    spread = _twin_spread(data, x0, y0, kw)
    for k in (0, 2):
        tol = max(1e-3, 3 * spread[k]) * max(1.0, want[k].abs().max().item())
        assert (got[k] - want[k]).abs().max().item() <= tol
    assert (got[4] == want[4]).float().mean().item() >= 0.75


def test_qp_inner_refuses_a_size_past_its_gate(cuda):
    n, m = 301, 842
    assert not qp_inner_fused.supported(n, m)
    z = lambda *s: torch.zeros(s, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        qp_inner_fused.solve_batched(
            torch.eye(n, device=cuda)[None], z(1, m, n), z(1, n), z(1, m), z(1, m),
            torch.ones((1, m), device=cuda), z(1, n), z(1, m))
    with pytest.raises(TypeError):
        qp_inner_fused.solve_batched(*(t.half() for t in _k3_data(2, torch.float32, cuda)),
                                     z(2, 26).half(), z(2, 57).half())


def test_qp_inner_gate_states_the_kernels_layout(cuda):
    """``qp_inner_fused.tier`` and ``smem_bytes`` restate the launcher's
    layout (the gate must answer on the CPU too, where no library is
    built): equal to the library's own at every n <= 64, m <= 900, both
    sides of the register tier's bound among them."""
    import ctypes

    from libmpc_tpu_torch.ops import _build

    lib, out = _build.library(), ctypes.c_longlong()
    for dtype in (torch.float32, torch.float64):
        size = torch.finfo(dtype).bits // 8
        for n in range(1, 65):
            for m in range(1, 901):
                reg = lib.libmpc_qp_inner_layout(n, m, size, ctypes.byref(out))
                assert (reg == 1) == (qp_inner_fused.tier(n, m) == "register"), (n, m)
                assert out.value == qp_inner_fused.smem_bytes(n, m, dtype), (n, m, dtype)


def test_batched_spd_routes_refuse_k_past_the_kernel_gate(cuda):
    """The kernel itself still refuses k > 64; the batched SPD routes no
    longer do: they run the blocked recursion through the kernel's leaves."""
    M = torch.eye(70, device=cuda).expand(2, 70, 70).contiguous()
    with pytest.raises(ValueError, match="k <= 64"):
        batched_linalg.chol_inverse(M)
    launches = batched_linalg.chol_inverse.launches
    inv = batched_linalg.spd_inverse(M)
    x = batched_linalg.spd_solve(M, torch.ones((2, 70), device=cuda))
    torch.cuda.synchronize()
    assert batched_linalg.chol_inverse.launches >= launches + 4
    assert (inv - M).abs().max().item() <= 1e-6 and (x - 1.0).abs().max().item() <= 1e-6


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.float64, 1e-10)])
@pytest.mark.parametrize("k", [130, 302])
def test_blocked_chol_inverse_matches_twin(cuda, dtype, tol, k):
    rng = np.random.default_rng(k)
    Q = rng.normal(size=(33, k, k))
    C = torch.as_tensor(Q @ Q.transpose(0, 2, 1) / k + 0.5 * np.eye(k), dtype=dtype,
                        device=cuda)
    got = batched_linalg.chol_inverse_blocked(C)
    want = batched_linalg.chol_inverse_plain(C)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= tol * want.abs().max().item()


def _traj_data(B, ph, bs_p, nx, w, dtype, device, seed=0, terms=None):
    """Quasi-definite bordered block-tridiagonal stage blocks: the generator
    of ``chip_smoke.traj_blocks`` (one copy serves the smoke run and these
    tests)."""
    return [torch.as_tensor(t, dtype=dtype, device=device)
            for t in chip_smoke.traj_blocks(B, ph, bs_p, nx, w, seed, terms)]


_TRAJ_SHAPES = [(37, 6, 5, 3, 4), (64, 20, 18, 12, 8), (5, 1, 3, 2, 3)]
# the edges of K4's tiles: bs = 33, one primal slot, a border wider than the
# block, the Van der Pol shape, the largest float64 block K4's gate admits
_K4_EDGE_SHAPES = [(37, 20, 20, 13, 9), (37, 8, 1, 1, 3), (37, 6, 5, 3, 12),
                   (64, 10, 3, 2, 3), chip_smoke.K4_LARGEST_F64]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.float64, 1e-10)])
@pytest.mark.parametrize("B,ph,bs_p,nx,w", _TRAJ_SHAPES + _K4_EDGE_SHAPES)
def test_traj_factor_kernel_matches_twin(cuda, dtype, tol, B, ph, bs_p, nx, w):
    """K4: Sinv, X and the symmetrized border Schur complement within ``tol``
    of the twin's scale; ragged batch, the oscillators' shape, a single
    stage and the edges of the kernel's tiles."""
    data = _traj_data(B, ph, bs_p, nx, w, dtype, cuda)
    launches = tsw.batched_factor.launches
    got = tsw.batched_factor(*data, bs_p)
    want = tsw.traj_factor_plain(*data, bs_p)
    torch.cuda.synchronize()
    assert tsw.batched_factor.launches == launches + 1
    sym = lambda M: 0.5 * (M + M.transpose(1, 2))
    for g, w_ in ((got[0], want[0]), (got[1], want[1]), (sym(got[2]), sym(want[2]))):
        assert (g - w_).abs().max().item() <= tol * w_.abs().max().item()


def test_traj_factor_float32_is_as_close_to_float64_as_its_twin(cuda):
    """On the ill-conditioned six-term blocks of the reference's test at the
    oscillators' width two float32 evaluations part at 1e-3; the kernel may be
    no further from the float64 twin than three times the float32 twin is."""
    t32 = _traj_data(256, 20, 18, 12, 8, torch.float32, cuda, seed=7, terms=6)
    kernel, twin, _ = chip_smoke.k4_float32_against_float64(torch, tsw, t32, 18)
    assert kernel.max() <= 3.0 * twin.max()
    assert np.median(kernel.max(axis=0)) <= 3.0 * np.median(twin.max(axis=0))


def _sweep_args(B, ph, bs_p, nx, w, dtype, device, unaligned=False):
    """K5's arguments from the twin's float64 factors of ``_traj_data``; with
    ``unaligned`` each is a contiguous view one element into a larger buffer,
    so that no base pointer is 16-byte aligned."""
    D, L, C, G = _traj_data(B, ph, bs_p, nx, w, torch.float64, device, seed=1)
    Sinv, X, Ghat = tsw.traj_factor_plain(D, L, C, G, bs_p)
    Gi = torch.linalg.inv(0.5 * (Ghat + Ghat.transpose(1, 2)))
    rng = np.random.default_rng(2)
    rs = torch.as_tensor(rng.normal(size=(B, ph, bs_p + nx)), device=device)
    rg = torch.as_tensor(rng.normal(size=(B, w)), device=device)
    args = [t.to(dtype).contiguous() for t in (Sinv, L, X, Gi, rs, rg)]
    if unaligned:
        args = [chip_smoke.unaligned_copy(torch, t) for t in args]
        # (L of a single-stage problem is empty and has no storage to offset)
        assert all(t.data_ptr() % 16 and t.is_contiguous() for t in args if t.numel())
    return args


def _check_sweep(args, tol):
    launches = tsw.batched_sweep_solve.launches
    got = tsw.batched_sweep_solve(*args)
    want = tsw.traj_solve_plain(*args)
    torch.cuda.synchronize()
    assert tsw.batched_sweep_solve.launches == launches + 1
    scale = want[0].abs().max().item() + 1.0
    for g, w_ in zip(got, want):
        assert (g - w_).abs().max().item() <= tol * scale


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float64, 1e-10)])
@pytest.mark.parametrize("B,ph,bs_p,nx,w", _TRAJ_SHAPES)
def test_traj_sweep_kernel_matches_twin(cuda, dtype, tol, B, ph, bs_p, nx, w):
    """K5 on the twin's float64 factors of the same data: xs and g within
    ``tol`` of (scale + 1)."""
    _check_sweep(_sweep_args(B, ph, bs_p, nx, w, dtype, cuda), tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float64, 1e-10)])
@pytest.mark.parametrize("B,ph,bs_p,nx,w", [(64, 20, 18, 12, 8), (37, 20, 20, 13, 9),
                                            (5, 1, 3, 2, 3)])
def test_traj_sweep_kernel_on_unaligned_inputs(cuda, dtype, tol, B, ph, bs_p, nx, w):
    """K5 on inputs whose base pointers are not 16-byte aligned (each a
    contiguous view one element into a larger buffer: the kernel then copies
    in 4- or 8-byte chunks), with the same tolerances."""
    _check_sweep(_sweep_args(B, ph, bs_p, nx, w, dtype, cuda, unaligned=True), tol)


def test_traj_sweep_kernel_at_the_largest_float64_factor_block(cuda):
    """K5 at ``K4_LARGEST_F64`` (bs = 72) in float64, one instance a block
    with two 87.5 KB stage buffers."""
    B, ph, bs_p, nx, w = chip_smoke.K4_LARGEST_F64
    assert tsw.sweeps_supported(ph, bs_p + nx, w, torch.float64)
    args = _sweep_args(B, ph, bs_p, nx, w, torch.float64, cuda)
    got = tsw.batched_sweep_solve(*args)
    want = tsw.traj_solve_plain(*args)
    torch.cuda.synchronize()
    scale = want[0].abs().max().item()
    for g, w_ in zip(got, want):
        assert (g - w_).abs().max().item() <= 1e-10 * scale


def test_traj_kernels_refuse_what_they_do_not_take(cuda):
    z = lambda *s: torch.zeros(s, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        tsw.batched_factor(z(1, 2, 300, 300), z(1, 1, 300, 300), z(1, 2, 300, 8), z(1, 8, 8), 200)
    with pytest.raises(ValueError, match="shared memory"):
        tsw.batched_sweep_solve(z(1, 2, 400, 400), z(1, 1, 400, 400), z(1, 2, 400, 8),
                                z(1, 8, 8), z(1, 2, 400), z(1, 8))
    with pytest.raises(TypeError):
        tsw.batched_factor(*(t.half() for t in _traj_data(2, 3, 3, 2, 3, torch.float32, cuda)), 3)
    D, L, C, G = _traj_data(2, 3, 3, 2, 3, torch.float32, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        tsw.batched_factor(D.transpose(2, 3), L, C, G, 3)
    with pytest.raises(ValueError, match="L must be"):
        tsw.batched_factor(D, L[:, :1], C, G, 3)


def test_admm_solve_each_kernel_path_matches_twin_path_float64(cuda):
    """The per-instance inner ADMM at the UGV shape (B = 256, n = 61,
    m = 123: the first SQP iteration's QPs of the shipped loop), float64:
    through K2, and with K2's plain twin substituted, equal statuses and
    iteration counts lane by lane, x within 1e-9 (absolute and relative, as
    the CPU parity tests)."""
    from libmpc_tpu_torch.ops import admm, sqp

    import libmpc_tpu_torch as lt

    (P, A, q, l, u), kw = chip_smoke.ugv_first_qps(torch, lt, admm)
    assert tuple(A.shape) == (256, 123, 61)
    d = lambda t: t.double()
    args = [d(t) for t in (P, A, q, l, u)]
    kw = dict(params=sqp._qp_params(False), eq_mask=kw["eq_mask"],
              warm_x=d(kw["warm_x"]), warm_y=d(kw["warm_y"]))
    before = batched_linalg.chol_inverse.launches
    sol_k = admm.admm_solve_each(*args, **kw)
    assert batched_linalg.chol_inverse.launches > before
    kernel = batched_linalg.chol_inverse
    batched_linalg.chol_inverse = batched_linalg.chol_inverse_plain
    try:
        sol_t = admm.admm_solve_each(*args, **kw)
    finally:
        batched_linalg.chol_inverse = kernel
    assert torch.equal(sol_k.status, sol_t.status)
    assert torch.equal(sol_k.iters, sol_t.iters)
    torch.testing.assert_close(sol_k.x, sol_t.x, rtol=1e-9, atol=1e-9)


def test_ugv_controller_two_steps_float32(cuda):
    """The shipped UGV configuration (float32, ``inner_qp="admm"``) for two
    closed-loop steps at B = 8 on the card: every status SUCCESS."""
    import libmpc_tpu_torch as lt
    from libmpc_tpu_torch.ops import admm

    c, plant, params_fn, x0, _ = chip_smoke.ugv_setup(torch, lt, torch.float32, 8)
    admm.admm_solve_each.trace = []
    try:
        r = lt.nlmpc_rollout(c, plant, x0, torch.zeros((8, 2), dtype=torch.float32,
                                                       device=cuda), 2, params_fn=params_fn)
        assert len(admm.admm_solve_each.trace) > 0
    finally:
        admm.admm_solve_each.trace = None
    assert r.inputs.dtype == torch.float32 and bool(torch.isfinite(r.inputs).all())
    assert (r.statuses == int(lt.ResultStatus.SUCCESS)).all(), r.statuses


def test_admm_solve_each_graph_replays_match_eager_launches(cuda, monkeypatch):
    """The per-instance loop's blocks replayed as CUDA graphs against the
    same blocks launched one kernel at a time, float64 at the UGV shape:
    equal statuses and iteration counts, x within 1e-9 (a graph's batch is
    padded to a power of two, and cuBLAS may pick other kernels for it)."""
    from libmpc_tpu_torch.ops import admm, sqp

    import libmpc_tpu_torch as lt

    (P, A, q, l, u), kw = chip_smoke.ugv_first_qps(torch, lt, admm)
    d = lambda t: t.double()
    args = [d(t) for t in (P, A, q, l, u)]
    kw = dict(params=sqp._qp_params(False), eq_mask=kw["eq_mask"],
              warm_x=d(kw["warm_x"]), warm_y=d(kw["warm_y"]))
    graphed = admm.admm_solve_each(*args, **kw)
    monkeypatch.setattr(admm, "_use_graphs", lambda device: False)
    eager = admm.admm_solve_each(*args, **kw)
    assert torch.equal(graphed.status, eager.status)
    assert torch.equal(graphed.iters, eager.iters)
    torch.testing.assert_close(graphed.x, eager.x, rtol=1e-9, atol=1e-9)


def _ugv_steps(graphs, steps=2, B=256):
    """The shipped UGV controller at batch ``B``, ``steps`` closed-loop
    steps from the same starts, with the SQP loop's evaluations replayed as
    CUDA graphs or (``graphs`` False) every capture refused so that they run
    eagerly: each step's (command, status, plan), evaluations, replays."""
    import libmpc_tpu_torch as lt
    from libmpc_tpu_torch.ops import sqp

    capture = sqp._EvalGraph.capture
    if not graphs:
        sqp._EvalGraph.capture = lambda self, inputs: False
    try:
        c, plant, params_fn, x, _ = chip_smoke.ugv_setup(torch, lt, torch.float32, B)
        u = torch.zeros((B, 2), dtype=torch.float32, device="cuda")
        out = []
        for k in range(steps):
            c.set_runtime_params(params_fn(x, k), batched=True)
            evals, replays = sqp.evals, sqp.replays
            r = c.optimize(x, u)
            out.append((r.cmd, r.status, c._opt_vector, sqp.evals - evals,
                        sqp.replays - replays))
            x, u = plant(x, r.cmd, k), r.cmd
    finally:
        sqp._EvalGraph.capture = capture
    return out


def test_sqp_evaluation_graphs_match_eager_at_the_ugv(cuda):
    """The UGV NLP at B = 256, float32, two closed-loop steps: the SQP
    loop's evaluations replayed as CUDA graphs give bitwise the commands,
    statuses and plans of the same evaluations launched eagerly, and the
    replays serve all but the first iteration's evaluations of each solve."""
    graphed, eager = _ugv_steps(True), _ugv_steps(False)
    for (cg, sg, zg, eg, rg), (ce, se, ze, ee, re) in zip(graphed, eager):
        assert torch.equal(sg, se) and torch.equal(cg, ce) and torch.equal(zg, ze)
        assert eg == ee and re == 0 and 0.8 * eg < rg < eg


_HOST_HALF = torch.tensor([0.5], dtype=torch.float64)  # a tensor on the host


def test_sqp_user_function_copying_from_the_host_solves_eagerly(cuda):
    """A constraint that copies a host tensor to the card inside it cannot
    be captured: the solve keeps its evaluations eager, counts no replay and
    gives the answer of the eager loop; the next solve of a capturable NLP
    in the same process replays."""
    from libmpc_tpu_torch.dims import NLDims
    from libmpc_tpu_torch.nlmpc import problem as nlp
    from libmpc_tpu_torch.ops import sqp
    from libmpc_tpu_torch.types import NLParameters

    dims = NLDims(2, 1, 2, 6, 3, 7, 0)
    kw = dict(dtype=torch.float64, device=cuda)

    def solve(host_copy):
        fns = nlp.NLFunctions(
            state_fn=lambda x, u, k: torch.stack(
                [(1.0 - x[1] * x[1]) * x[0] - x[1] + u[0], x[0]]),
            objective_fn=lambda X, Y, U, e: torch.sum(X**2) + torch.sum(U**2),
            ineq_fn=((lambda X, Y, U, e: U[:, 0] - _HOST_HALF.to(U.device)) if host_copy
                     else (lambda X, Y, U, e: U[:, 0] - 0.5)),
            continuous=True, ts=0.1)
        a = (dims, fns, torch.ones(2, **kw), torch.ones(1, **kw))
        x0 = torch.as_tensor(np.random.default_rng(0).uniform(-1, 1, (64, 2)), **kw)
        z0 = torch.cat([x0.repeat(1, 6), torch.zeros((64, 4), **kw)], dim=1)
        lb = torch.full((dims.nz,), -float("inf"), **kw)
        ub = torch.full((dims.nz,), float("inf"), **kw)
        lb[-1] = ub[-1] = 0.0
        evals, replays = sqp.evals, sqp.replays
        sol = sqp.sqp_solve(lambda z, x: nlp.objective(*a, z, x),
                            lambda z, x: nlp.state_defects(*a, z, x),
                            lambda z, x: nlp.user_ineq(*a, z, x),
                            z0, lb, ub, NLParameters(maximum_iteration=60),
                            fn_args=(x0,), fn_in_dims=(0,))
        return sol, sqp.evals - evals, sqp.replays - replays

    copied, evals, replays = solve(True)
    assert int(copied.iters.max()) >= 3 and evals > 0 and replays == 0
    capture = sqp._EvalGraph.capture
    sqp._EvalGraph.capture = lambda self, inputs: False
    try:
        eager, _, _ = solve(True)
    finally:
        sqp._EvalGraph.capture = capture
    for a, b in zip(copied, eager):
        assert torch.equal(a, b)
    plain, evals, replays = solve(False)
    assert 0 < replays < evals
    torch.testing.assert_close(plain.z, eager.z, rtol=0, atol=1e-12)


# -- K6: the SQP's eigenvalue clipping ----------------------------------------

_K6_TOL = {torch.float32: 2e-5, torch.float64: 1e-12}
_K6_LARGEST = {torch.float32: 168, torch.float64: 118}


def _k6_error(got, H):
    """Largest relative Frobenius distance of K6's lanes from the float64
    twin's."""
    want = batched_linalg.eig_clip_plain(H.double())
    return float((torch.linalg.matrix_norm(got.double() - want)
                  / torch.linalg.matrix_norm(want)).max())


def _k6(H, monkeypatch):
    """K6 on H, with ``torch.linalg.eigh`` made to raise; checks one launch,
    no host read and an exactly symmetric result."""
    monkeypatch.setattr(torch.linalg, "eigh",
                        lambda *a, **k: pytest.fail("torch.linalg.eigh ran"))
    launches, reads = batched_linalg.eig_clip.launches, _host.reads
    out = batched_linalg.eig_clip(H)
    torch.cuda.synchronize()
    monkeypatch.undo()
    assert batched_linalg.eig_clip.launches == launches + 1
    assert _host.reads == reads
    torch.testing.assert_close(out, out.transpose(1, 2), rtol=0, atol=0, equal_nan=True)
    return out


def _spectrum(B, n, w, dtype, device, seed=0):
    """Q diag(w) Q' for a random orthogonal Q a lane."""
    Q = np.linalg.qr(np.random.default_rng(seed).normal(size=(B, n, n)))[0]
    return torch.as_tensor((Q * np.asarray(w)[..., None, :]) @ Q.transpose(0, 2, 1),
                           dtype=dtype, device=device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_eig_clip_kernel_matches_float64_twin_at_the_ugv_shape(cuda, dtype, monkeypatch):
    H = torch.as_tensor(chip_smoke.symmetric_batch(256, 61, seed=1), dtype=dtype, device=cuda)
    batched_linalg.eig_clip.trace = []
    try:
        out = _k6(H, monkeypatch)
        (sweeps,) = batched_linalg.eig_clip.trace
    finally:
        batched_linalg.eig_clip.trace = None
    assert _k6_error(out, H) <= _K6_TOL[dtype]
    assert sweeps.device == H.device and sweeps.shape == (256,)
    assert 1 <= int(sweeps.min()) and int(sweeps.max()) <= (20 if dtype == torch.float32 else 30)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 2, 5, 24, 33, 61, 64, "largest"])
def test_eig_clip_every_size(cuda, dtype, n, monkeypatch):
    """Every size to the tier's largest; the rounding of a sweep's rotations
    adds up over about n of them an entry, so past the UGV's 61 the bound
    grows with n."""
    n = _K6_LARGEST[dtype] if n == "largest" else n
    H = torch.as_tensor(chip_smoke.symmetric_batch(5 if n > 100 else 37, n, seed=n),
                        dtype=dtype, device=cuda)
    assert _k6_error(_k6(H, monkeypatch), H) <= _K6_TOL[dtype] * max(1.0, n / 61)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_eig_clip_repeated_eigenvalues(cuda, dtype, monkeypatch):
    """Clusters of 20 equal eigenvalues, one of them negative (clipped): the
    clipped matrix is unique though V is not."""
    w = np.repeat([3.0, -1.0, 1e-3], [20, 20, 21])
    H = _spectrum(16, 61, w, dtype, cuda)
    assert _k6_error(_k6(H, monkeypatch), H) <= _K6_TOL[dtype]
    H = _spectrum(16, 61, np.ones(61), dtype, cuda, seed=2)  # a multiple of I
    assert _k6_error(_k6(H, monkeypatch), H) <= _K6_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_eig_clip_returns_a_positive_definite_input(cuda, dtype, monkeypatch):
    w = np.random.default_rng(3).uniform(0.1, 10.0, size=(32, 61))
    H = _spectrum(32, 61, w, dtype, cuda, seed=3)
    out = _k6(H, monkeypatch)
    rel = torch.linalg.matrix_norm(out.double() - H.double()) / torch.linalg.matrix_norm(H.double())
    assert float(rel.max()) <= _K6_TOL[dtype]
    D = torch.diag_embed(torch.linspace(1.0, 2.0, 61, dtype=dtype, device=cuda)).expand(4, 61, 61)
    assert _k6_error(_k6(D.contiguous(), monkeypatch), D) <= _K6_TOL[dtype]  # no sweep


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("scale", [1e-6, 1e-3, 1e3, 1e6])
def test_eig_clip_scales(cuda, dtype, scale, monkeypatch):
    H = torch.as_tensor(scale * chip_smoke.symmetric_batch(64, 61, seed=4), dtype=dtype,
                        device=cuda)
    assert _k6_error(_k6(H, monkeypatch), H) <= _K6_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_eig_clip_nan_lane_stays_apart(cuda, dtype, monkeypatch):
    H = torch.as_tensor(chip_smoke.symmetric_batch(37, 61, seed=5), dtype=dtype, device=cuda)
    clean = _k6(H, monkeypatch)
    H[3, 7, 11] = float("nan")
    H[9, 0, 0] = float("inf")
    batched_linalg.eig_clip.trace = []
    try:
        out = _k6(H, monkeypatch)
        (sweeps,) = batched_linalg.eig_clip.trace
    finally:
        batched_linalg.eig_clip.trace = None
    bad = torch.zeros(37, dtype=torch.bool, device=cuda)
    bad[[3, 9]] = True
    assert bool(torch.isnan(out[bad]).all()) and bool((sweeps[bad] == 0).all())
    assert torch.equal(out[~bad], clean[~bad])


def test_eig_clip_past_its_tier_runs_the_library_route(cuda):
    for dtype, largest in _K6_LARGEST.items():
        H = torch.as_tensor(chip_smoke.symmetric_batch(2, largest + 1, seed=6), dtype=dtype,
                            device=cuda)
        with pytest.raises(RuntimeError, match="CUDA error"):
            batched_linalg._eig_clip_launch(H)  # the launcher refuses the size
        launches = batched_linalg.eig_clip.launches
        out = batched_linalg.eig_clip(H)
        assert batched_linalg.eig_clip.launches == launches
        assert torch.equal(out, batched_linalg.eig_clip_plain(H))


def _vdp_eigh_solve(dtype, device):
    """An ``hessian_reg="eigh"`` SQP solve of a Van der Pol NLP, 64 lanes."""
    from libmpc_tpu_torch.dims import NLDims
    from libmpc_tpu_torch.nlmpc import problem as nlp
    from libmpc_tpu_torch.ops import sqp
    from libmpc_tpu_torch.types import NLParameters

    dims = NLDims(2, 1, 2, 6, 3, 7, 0)
    kw = dict(dtype=dtype, device=device)
    fns = nlp.NLFunctions(
        state_fn=lambda x, u, k: torch.stack([(1.0 - x[1] * x[1]) * x[0] - x[1] + u[0], x[0]]),
        objective_fn=lambda X, Y, U, e: torch.sum(X**2) + torch.sum(U**2),
        ineq_fn=lambda X, Y, U, e: U[:, 0] - 0.5, continuous=True, ts=0.1)
    a = (dims, fns, torch.ones(2, **kw), torch.ones(1, **kw))
    x0 = torch.as_tensor(np.random.default_rng(0).uniform(-1, 1, (64, 2)), **kw)
    z0 = torch.cat([x0.repeat(1, 6), torch.zeros((64, 4), **kw)], dim=1)
    lb = torch.full((dims.nz,), -float("inf"), **kw)
    ub = torch.full((dims.nz,), float("inf"), **kw)
    lb[-1] = ub[-1] = 0.0
    return sqp.sqp_solve(lambda z, x: nlp.objective(*a, z, x),
                         lambda z, x: nlp.state_defects(*a, z, x),
                         lambda z, x: nlp.user_ineq(*a, z, x), z0, lb, ub,
                         NLParameters(maximum_iteration=60, hessian_reg="eigh"),
                         fn_args=(x0,), fn_in_dims=(0,))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_sqp_eigh_solve_convexifies_by_one_k6_launch_an_iteration(cuda, dtype, monkeypatch):
    """An ``hessian_reg="eigh"`` SQP solve on the card launches K6 once a
    lockstep iteration, never runs ``torch.linalg.eigh`` and reads nothing
    back for it; with the library route forced, each convexification reads
    its status once."""
    from libmpc_tpu_torch.ops import sqp

    calls = []
    convexify = sqp._eigh_convexify

    def counted(H):
        reads = _host.reads
        out = convexify(H)
        calls.append(_host.reads - reads)
        return out

    monkeypatch.setattr(sqp, "_eigh_convexify", counted)
    monkeypatch.setattr(torch.linalg, "eigh",
                        lambda *a, **k: pytest.fail("torch.linalg.eigh ran"))
    launches = batched_linalg.eig_clip.launches
    sol = _vdp_eigh_solve(dtype, cuda)
    iters = int(sol.iters.max())
    assert iters >= 3 and bool(torch.isfinite(sol.z).all())
    assert batched_linalg.eig_clip.launches - launches == iters == len(calls)
    assert set(calls) == {0}
    monkeypatch.undo()
    monkeypatch.setattr(sqp, "_eigh_convexify", counted)
    monkeypatch.setattr(batched_linalg, "eig_clip_supported", lambda n, dtype: False)
    calls.clear()
    plain = _vdp_eigh_solve(dtype, cuda)
    assert len(calls) == int(plain.iters.max()) and set(calls) == {1}


@pytest.fixture
def nccl_mesh(cuda, tmp_path):
    """One NCCL rank on the card (a file store under ``tmp_path``, 60 s
    collective timeout), torn down after the test."""
    import torch.distributed as dist

    from libmpc_tpu_torch import parallel as par

    par.init_distributed(f"file://{tmp_path / 'store'}", 1, 0, backend="nccl", timeout=60)
    try:
        yield par.make_mesh()
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("kind,B,K", [("lmpc", 1024, 3), ("nlmpc", 256, 2)])
def test_one_nccl_rank_fleet_is_the_controller_bitwise(nccl_mesh, kind, B, K):
    """The quadrotor LMPCFleet and the Van der Pol NLMPCFleet, float32, as
    one NCCL rank: the commands of every closed-loop step equal the plain
    controller's on the same inputs to the bit, the stats count its
    statuses, and the fleet path launched its kernels."""
    import libmpc_tpu_torch as lt
    from libmpc_tpu_torch import parallel as par
    from libmpc_tpu_torch.ops import trajectory_sweeps as tsw

    mods = (admm_fused, batched_linalg, qp_inner_fused, tsw)
    r = chip_smoke.fleet_against_plain(torch, lt, par, nccl_mesh, kind, B, K, mods)
    for f, p in zip(r["fleet_cmd"], r["plain_cmd"]):
        assert chip_smoke.same_cmds(torch, f, p)
    for s, p in zip(r["stats"], r["plain_status"]):
        assert s.n_total == B and s.n_success == int((p == 0).sum())
    assert r["launches"]["chol_inverse"] > 0
    assert r["launches"]["admm_fused" if kind == "lmpc" else "qp_inner"] > 0


def test_two_gloo_ranks_row_sharded_qp_match_one_rank(cuda, tmp_path):
    """The quadrotor QP (float64, B = 64, the closed-loop settings) through
    ``solve_sharded`` on a (1, 2) mesh of two gloo ranks sharing the card,
    against one rank alone: statuses and iterations equal, x within 1e-9,
    and both ranks return the same global solution; no K1 launch."""
    import libmpc_tpu_torch as lt
    from libmpc_tpu_torch import parallel as par

    mods = (admm_fused, batched_linalg, qp_inner_fused, tsw)
    recs = chip_smoke.spawn_ranks("qp", 2, tmp_path, 240,
                                  ("--qp-mesh", "1,2", "--qp-batch", "64"))
    one = chip_smoke.qps_run(torch, lt, par, par.make_mesh(1, 1), torch.float64, 64,
                             mods)["sol"]
    for rec in recs:
        assert np.array_equal(rec["f64_x"], recs[0]["f64_x"])
        assert np.array_equal(rec["f64_y"], recs[0]["f64_y"])
        k1 = chip_smoke.QPS_NUMBERS.index("k1_launches")
        assert rec["f64_numbers"][k1] == 0 and rec["f32_numbers"][k1] == 0
    assert np.array_equal(recs[0]["f64_status"], one.status.cpu().numpy())
    assert np.array_equal(recs[0]["f64_iters"], one.iters.cpu().numpy())
    assert np.abs(recs[0]["f64_x"] - one.x.cpu().numpy()).max() <= 1e-9


def test_compat_quadrotor_golden_float32(cuda):
    """tests/test_compat.py's quadrotor script through
    ``libmpc_tpu_torch.compat`` on the card in float32: the golden within
    1e-4, status SUCCESS, results on the card; K1 launched."""
    import libmpc_tpu_torch.compat as mpc

    launches = admm_fused.fused_iterations.launches
    res, seq = chip_smoke.compat_quadrotor(mpc, dtype=torch.float32)
    assert res.cmd.device.type == "cuda" and seq.state.device.type == "cuda"
    assert np.abs(res.cmd.cpu().numpy() - chip_smoke.GOLDEN_CMD).max() <= 1e-4
    assert res.status_enum == mpc.SUCCESS
    assert tuple(seq.state.shape) == (11, 12)
    assert admm_fused.fused_iterations.launches > launches


def test_float64_admm_solve_on_the_card_matches_native_oracle(cuda):
    """The card's float64 ``admm_solve`` on the quadrotor QP against the
    native C++ oracle (tests/test_native_oracle.py's settings): x within
    1e-5, the oracle's command within 1e-4 of the golden."""
    import libmpc_tpu_torch as lt
    from libmpc_tpu_torch import native_qp

    if not native_qp.available():
        pytest.skip("native toolchain unavailable (g++)")
    dx, status, _, golden, _ = chip_smoke.oracle_quadrotor(torch, lt, "cuda")
    assert status == 1
    assert dx <= 1e-5
    assert golden <= 1e-4


@pytest.mark.parametrize("dtype,tier", [(torch.float32, 1), (torch.float32, 0),
                                        (torch.float64, 0)])
def test_fused_iterations_nan_bound_gives_nan_as_the_twin(cuda, dtype, tier):
    """A lane with a NaN bound (a NaN state puts NaN in the initial-state
    rows' l = u) ends NaN where the twin's torch.clamp puts NaN, in each
    tier; the other lanes agree with the twin as usual."""
    B, n, m = 37, 24, 40
    q, l, u, A, M, Minv, rho = _k1_data(B, n, m, dtype, cuda)
    l[5, :3] = u[5, :3] = float("nan")
    lay = (admm_fused.staged_layout(B, n, m) if tier == 1
           else admm_fused.stream_layout(B, n, m, dtype))
    zeros = lambda w: torch.zeros((B, w), dtype=dtype, device=cuda)
    done = torch.zeros(B, dtype=torch.bool, device=cuda)
    kw = dict(sigma=1e-5, alpha=1.6, refine=dtype == torch.float32, k_iters=10)
    args = (zeros(n), zeros(m), zeros(m), done, q, l, u, A, M, Minv, rho)
    got = admm_fused.launch(lay, *args, **kw)
    want = admm_fused.plain_iterations(*args, **kw)
    torch.cuda.synchronize()
    ok = torch.ones(B, dtype=torch.bool, device=cuda)
    ok[5] = False
    assert torch.isnan(want[0][5]).all() and torch.isnan(want[1][5]).any()
    for g, w in zip(got, want):
        assert torch.equal(torch.isnan(g), torch.isnan(w))
        assert (g[ok] - w[ok]).abs().max().item() <= _K1_TOL[dtype] * w[ok].abs().max().item()


def test_qp_inner_nan_bound_gives_nan_as_the_twin(cuda):
    """K3's projection: a lane with a NaN bound ends with NaN where the
    twin's does, float64; the other lanes' done flags and iterations are
    the twin's."""
    B = 16
    data = _k3_data(B, torch.float64, cuda)
    data[3][2, :2] = data[4][2, :2] = float("nan")
    x0 = torch.zeros((B, 26), dtype=torch.float64, device=cuda)
    y0 = torch.zeros((B, 57), dtype=torch.float64, device=cuda)
    kw = dict(_K3_KW, eps_abs=1e-9, eps_rel=1e-9, max_iter=2000)
    got = qp_inner_fused.solve_batched(*data, x0, y0, **kw)
    want = qp_inner_fused.plain_solve_batched(*data, x0, y0, **kw)
    torch.cuda.synchronize()
    for g, w in zip(got[:3], want[:3]):
        assert torch.equal(torch.isnan(g), torch.isnan(w))
    assert torch.isnan(want[0][2]).any()
    assert torch.equal(got[3], want[3]) and torch.equal(got[4], want[4])


def test_lmpc_nan_state_lane_holds_its_command(cuda):
    """The quadrotor LMPC in float32 on the card (K1's path): a lane whose
    state turns NaN reports ERROR and holds its last command; the others
    solve (serving_ex's failure containment)."""
    import libmpc_tpu_torch as lt

    c = chip_smoke.quadrotor_controller(lt, torch.float32, "cuda", lt.LParameters(
        maximum_iteration=100, enable_warm_start=True, rho=0.01))
    x = 0.03 * np.random.default_rng(0).normal(size=(8, 12))
    r = c.optimize(x, np.zeros((8, 4)))
    held = r.cmd[3].clone()
    x[3] = np.nan
    launches = admm_fused.fused_iterations.launches
    r = c.optimize(x, r.cmd)
    assert admm_fused.fused_iterations.launches > launches
    status = r.status.cpu().numpy()
    assert status[3] == int(lt.ResultStatus.ERROR)
    assert torch.equal(r.cmd[3], held)
    assert (np.delete(status, 3) == 0).all()


def _warm_controller(kind):
    """The quadrotor LMPC at B=1024 (closed-loop settings) or the shipped
    UGV NLMPC at B=8, float32 on the card, after one solve: (controller,
    state, last command) of a warm step."""
    import libmpc_tpu_torch as lt

    if kind == "lmpc":
        c = chip_smoke.quadrotor_controller(lt, torch.float32, "cuda",
                                            chip_smoke.closed_loop_params(lt))
        x = torch.as_tensor(0.05 * np.random.default_rng(1).normal(size=(1024, 12)),
                            dtype=torch.float32, device="cuda")
        u = torch.zeros((1024, 4), dtype=torch.float32, device="cuda")
    else:
        c, _plant, params_fn, x, _ = chip_smoke.ugv_setup(torch, lt, torch.float32, 8)
        c.set_runtime_params(params_fn(x, 0), batched=True)
        u = torch.zeros((8, 2), dtype=torch.float32, device="cuda")
    r = c.optimize(x, u)
    torch.cuda.synchronize()
    return c, x, r.cmd


@pytest.mark.parametrize("kind", ["lmpc", "nlmpc"])
def test_every_synchronizing_call_of_optimize_is_in_host(cuda, kind):
    """Under ``torch.cuda.set_sync_debug_mode("warn")`` a warm ``optimize``
    of each cell's controller warns only where the innermost frame of the
    port is ``ops/_host.py``: every read the host waits for goes through
    the one counted place."""
    import traceback
    import warnings

    from libmpc_tpu_torch.ops import _host

    c, x, u = _warm_controller(kind)
    where = []

    def hook(message, *a, **k):
        if "called a synchronizing CUDA operation" in str(message):
            ours = [f for f in traceback.extract_stack()[:-1]
                    if "libmpc_tpu_torch" in f.filename.replace("\\", "/")]
            where.append(f"{ours[-1].filename}:{ours[-1].lineno}" if ours else "outside")

    reads = _host.reads
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            c.optimize(x, u)
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert where, "no synchronizing call was reported"
    assert all(w.replace("\\", "/").split(":")[0].endswith("ops/_host.py")
               for w in where), sorted(set(where))
    assert _host.reads - reads >= len(where)


def test_spans_have_no_device_work(cuda):
    """A profiled warm step of the quadrotor LMPC: the program's spans are
    on the host timeline, and none of the card's activities that the
    benchmark counts (``mpcbench/trace.py``) carries a ``libmpc.`` name
    (the spans' mirrors on the device timeline are annotations, not work)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from mpcbench import trace

    c, x, u = _warm_controller("lmpc")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(trace.WINDOW_SPAN):
            c.optimize(x, u)
            torch.cuda.synchronize()
    p = trace.read_profile(prof, 1)
    assert p.kernels() > 0
    assert not [n for n, _, _ in p.device if n.startswith("libmpc.")]
    host = {n for n, _, _ in p.host}
    assert {"libmpc.lmpc.optimize", "libmpc.admm.solve", "libmpc.admm.check"} <= host
