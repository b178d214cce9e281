"""Trajectory-KKT factorization and solve sweeps: the hand-written CUDA
kernels and their twins.

Counterpart of ``libmpc_tpu/ops/trajectory_sweeps.py``.  The Newton systems
of the banded-KKT interior point (``ops/trajectory_kkt.py``) are bordered
block-tridiagonal and quasi-definite: ``ph`` stage blocks of size ``bs``
(``bs_p`` primal slots, then the stage's multipliers) coupled to their
neighbours by ``L_k`` and to a ``w``-wide border by ``C_k``.

* :func:`batched_factor` eliminates the stages in order,
  ``S_k = D_k - L_{k-1} S_{k-1}^-1 L_{k-1}'``,
  ``Z_k = C_k - L_{k-1} S_{k-1}^-1 Z_{k-1}``, inverts each quasi-definite
  pivot block through two SPD inverses, accumulates the border Schur
  complement ``Ghat = G - sum_k Z_k' S_k^-1 Z_k`` and sweeps backward for
  ``X = T^-1 C``.  On CUDA tensors it is one launch of
  ``csrc/traj_factor.cu``, which replaces the two Pallas kernels of
  ``trajectory_sweeps.py::batched_factor`` (``pallas_call`` at ``:201`` and
  ``:233``); on CPU tensors it is :func:`traj_factor_plain`.
* :func:`batched_sweep_solve` solves the factored system for one right-hand
  side: the forward recursion ``u_k = S_k^-1 (r_k - L_{k-1} u_{k-1})`` with
  the border reduction ``sum_k X_k' r_k``, the border solve, and the backward
  recursion.  On CUDA tensors it is one launch of ``csrc/traj_sweep.cu``,
  which replaces the two Pallas kernels and the einsum between them of
  ``trajectory_sweeps.py::batched_sweep_solve`` (``pallas_call`` at ``:337``
  and ``:375``); on CPU tensors it is :func:`traj_solve_plain`.

Both twins restate the per-instance recursions of
``libmpc_tpu/ops/trajectory_kkt.py`` (``_traj_factor_seq`` with
``_qd_inverse``, ``_traj_solve_seq``) batch-first, with the same arithmetic
in the same order.

What bounds the kernels on an H100, and what their designs do about it.
Both are recursions over the stages: stage k cannot start before stage k-1
is done, so one instance is a chain of ``ph`` dependent steps and the card
is filled by running many instances side by side, not by splitting one.
The TPU kernels put 128 instances in the vector lanes and step a grid over
(tile, stage); the padded lanes, the clamped duplicate of ``L`` and the
batch-last layout exist only for that and do not carry over.  Here the
tensors are read batch-first as they are and a ragged batch is a bounds
check.

* The factorization does about ``4 bs^3`` multiply-adds per stage on a
  working set of some 25 KB.  One block of 128 threads owns one instance
  (eight blocks an SM at the oscillators' shape, the whole batch in one
  wave), so one instance's chain of ``ph`` stages, each some forty barrier
  phases long, sets the time, and what the eight blocks of an SM issue
  between them adds to it.  Every product goes through one register-tiled
  routine: a thread owns a small tile of the output (up to 3 x 4) and per
  term loads a few values of the left operand and one vector of the right,
  from shared memory laid out with leading dimensions that keep both reads
  free of bank conflicts; ``[S_k | Z_k]`` is updated in one pass with
  ``[L_{k-1}' | Z_{k-1}]`` as the right operand.  The two SPD inverses of
  the quasi-definite pivot (``csrc/chol_block.cuh``) are a right-looking
  Cholesky factorization with the triangular inverse one pivot behind it,
  one barrier a pivot, the pivot's reciprocals computed a phase ahead, and
  ``S^-1 = L^-T L^-1`` through the tiles.  The next stage's ``D``, ``C``
  and ``L'`` (and, on the way back, ``L``, ``S^-1`` and ``U``) arrive by
  ``cp.async`` while the current stage computes.  The first pass writes
  ``S_k^-1`` and ``U_k = S_k^-1 Z_k`` out; the backward pass of the same
  block reads them back.
* The solve does two operations per word it reads, so bytes bound it:
  ``S_k^-1``, ``L_k`` and ``X_k``, read once forward and once backward,
  and one instance is a chain of ``2 ph - 1`` steps, so each step's stage
  must already be on its way when the step before ends.  One warp owns one
  instance and one instance a block: the stage's three matrices sit
  contiguous in one of two stage buffers, and while a step computes the
  next step's buffer fills by ``cp.async`` (16-byte chunks, or 8 or 4 bytes
  where a base pointer or a stride is not 16-byte aligned), forward and
  backward through one pipeline; ``r`` is loaded whole and turned into
  ``u`` in place.  A lane computes one row of each product; rows are read
  two elements a load and columns across lanes, so neither collides on a
  bank.

Measured on an NVIDIA H100 80GB HBM3 (700 W) at B=1024, ph=20, bs=30, w=8,
float32 (``chip_smoke.py``): the factorization 1.04 ms (2.33 before its
redesign) against a bound of 0.077 ms, and 0.58 ms with one instance per SM
alone, so one instance's chain of barrier phases, of which the two SPD
inverses are about half (``--k4-clocks``), is most of its time; the solve
0.119 ms (0.549 before its redesign; float64 0.233) against 0.050 ms for
every byte read once and 0.099 ms with the backward re-read, and 0.074 ms
with one instance per SM alone (``PERF.md``).

:func:`factor_supported` and :func:`sweeps_supported` are the kernels' own
gates: the shared memory of one instance must fit the 227 KB a block can
use.  A request past a gate raises; it is not handed to the twin.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build, batched_linalg

SMEM_LIMIT_BYTES = 232448  # dynamic shared memory one Hopper block can use
FACTOR_THREADS = 128  # threads of the block that owns one instance (K4; 64, 256 slower)
SWEEP_WARPS = 1  # instances (one warp each) per block (K5; 2, 4, 8 no faster)


def _itemsize(dtype: torch.dtype) -> int:
    return torch.finfo(dtype).bits // 8


def _ld(cols: int, itemsize: int) -> int:
    """Leading dimension of a shared-memory matrix of ``cols`` columns in the
    factor kernel: a multiple of the vector width, offset (float 4 mod 8,
    double 2 mod 4) so that rows a few apart fall in distinct banks."""
    return (cols + 7) // 8 * 8 + 4 if itemsize == 4 else (cols + 3) // 4 * 4 + 2


def factor_smem_bytes(bs: int, bs_p: int, w: int,
                      dtype: torch.dtype = torch.float32) -> int:
    """Shared memory of one instance in the factor kernel
    (``csrc/traj_factor.cu::factor_layout``): the pivot inverse and the
    product ``L S^-1`` (``bs`` x ``bs`` each, or the workspaces of the
    quasi-definite inverse and of the backward sweep where those are
    larger), two ``[S_k | Z_k]`` buffers and one ``[L' | Z]`` buffer
    (``bs`` x (``bs`` rounded up to 4, + ``w``)), the ``w`` x ``w`` border
    sum, the pivot reciprocals of the Cholesky factors and a tail of four
    rows that padded tiles may read."""
    it = _itemsize(dtype)
    p, n = bs_p, bs - bs_p
    bsP = (bs + 3) // 4 * 4
    ldS, ldZ = _ld(bs, it), _ld(bsP + w, it)
    ldp, ldn, ldw = _ld(p, it), _ld(n, it), _ld(w, it)
    sp = max(bs * ldS, 2 * p * ldp, 3 * n * ldn)
    ls = max(bs * ldS, p * ldp + n * ldp + n * ldn, 2 * bs * ldw)
    words = sp + ls + 3 * bs * ldZ + (w * w + 2 * max(p, n) + 3) // 4 * 4 + 4 * ldZ
    return words * it


def factor_supported(ph: int, bs: int, bs_p: int, w: int,
                     dtype: torch.dtype = torch.float32) -> bool:
    """Whether the CUDA factor kernel takes this shape: at least one stage,
    primal and dual slots in every stage block, and one instance within a
    block's shared memory."""
    return (ph >= 1 and 1 <= bs_p < bs and w >= 1
            and factor_smem_bytes(bs, bs_p, w, dtype) <= SMEM_LIMIT_BYTES)


def _round16(n: int, itemsize: int) -> int:
    a = 16 // itemsize
    return (n + a - 1) // a * a


def sweep_smem_bytes(ph: int, bs: int, w: int,
                     dtype: torch.dtype = torch.float32) -> int:
    """Shared memory of one instance in the sweep kernel
    (``csrc/traj_sweep.cu::sweep_layout``): two stage buffers of ``S^-1``,
    ``L`` (``bs`` x ``bs`` each) and ``X`` (``bs`` x ``w``) stored
    contiguous, the ``ph`` running vectors, two work vectors of ``bs`` and
    two of ``w``, every piece on a 16-byte boundary."""
    it = _itemsize(dtype)
    r = lambda n: _round16(n, it)
    stage = 2 * r(bs * bs) + r(bs * w)
    words = 2 * stage + r(ph * bs) + 2 * r(bs) + 2 * r(w)
    return words * it


def sweeps_supported(ph: int, bs: int, w: int,
                     dtype: torch.dtype = torch.float32) -> bool:
    """Whether the CUDA sweep kernel takes this shape: one instance within a
    block's shared memory."""
    return (ph >= 1 and bs >= 1 and w >= 1
            and sweep_smem_bytes(ph, bs, w, dtype) <= SMEM_LIMIT_BYTES)


# -- plain twins --------------------------------------------------------------
def _sym(M):
    return 0.5 * (M + M.transpose(-1, -2))


def qd_inverse_plain(S, p: int):
    """Inverse of a batch of symmetric quasi-definite blocks ``S`` (B, bs,
    bs) whose leading ``p`` slots are positive (primal) and trailing slots
    negative (dual), via two SPD inverses (``trajectory_kkt.py:343``)."""
    A = S[:, :p, :p]
    Bl = S[:, p:, :p]
    C = -S[:, p:, p:]
    Ai = batched_linalg.chol_inverse_plain(_sym(A))
    W = Bl @ Ai  # (B, n, p)
    S2 = C + W @ Bl.transpose(1, 2)
    S2i = batched_linalg.chol_inverse_plain(_sym(S2))
    TR = W.transpose(1, 2) @ S2i  # (B, p, n)
    TL = Ai - TR @ W
    top = torch.cat([TL, TR], dim=2)
    bot = torch.cat([TR.transpose(1, 2), -S2i], dim=2)
    return torch.cat([top, bot], dim=1)


def traj_factor_plain(D, L, C, G, bs_p: int):
    """The factor kernel's twin (``trajectory_kkt.py:369`` batch-first):
    ``D`` (B, ph, bs, bs), ``L`` (B, ph-1, bs, bs), ``C`` (B, ph, bs, w),
    ``G`` (B, w, w) -> (Sinv (B, ph, bs, bs), X (B, ph, bs, w), Ghat
    (B, w, w)).  The caller inverts the symmetrized ``Ghat``."""
    ph = D.shape[1]
    Sinv, Z = [], []
    Ghat = G
    for k in range(ph):
        if k == 0:
            Sk, Zk = D[:, 0], C[:, 0]
        else:
            LS = L[:, k - 1] @ Sinv[k - 1]
            Sk = D[:, k] - LS @ L[:, k - 1].transpose(1, 2)
            Zk = C[:, k] - LS @ Z[k - 1]
        Ski = qd_inverse_plain(Sk, bs_p)
        Sinv.append(Ski)
        Z.append(Zk)
        Ghat = Ghat - Zk.transpose(1, 2) @ (Ski @ Zk)
    # X = T^-1 C: U_k = Sinv_k Z_k forward, then the backward sweep
    X = [None] * ph
    X[ph - 1] = Sinv[ph - 1] @ Z[ph - 1]
    for k in range(ph - 2, -1, -1):
        X[k] = Sinv[k] @ Z[k] - Sinv[k] @ (L[:, k].transpose(1, 2) @ X[k + 1])
    return torch.stack(Sinv, dim=1), torch.stack(X, dim=1), Ghat


def traj_solve_plain(Sinv, L, X, Ghat_inv, r_stage, r_g):
    """The sweep kernel's twin (``trajectory_kkt.py:462`` batch-first):
    ``r_stage`` (B, ph, bs), ``r_g`` (B, w) -> (xs (B, ph, bs), g (B, w))."""
    ph = Sinv.shape[1]
    mv = lambda M, v: torch.einsum("bij,bj->bi", M, v)
    vm = lambda v, M: torch.einsum("bi,bij->bj", v, M)
    # forward: u_k = Sinv_k (r_k - L_{k-1} u_{k-1})
    u = [None] * ph
    u[0] = mv(Sinv[:, 0], r_stage[:, 0])
    for k in range(1, ph):
        u[k] = mv(Sinv[:, k], r_stage[:, k] - mv(L[:, k - 1], u[k - 1]))
    # border: g = Ghat^-1 (r_g - X' r)
    xtr = vm(r_stage[:, 0], X[:, 0])
    for k in range(1, ph):
        xtr = xtr + vm(r_stage[:, k], X[:, k])
    g = mv(Ghat_inv, r_g - xtr)
    # backward: xT_k = u_k - Sinv_k L_k' xT_{k+1}; then subtract X g
    x = [None] * ph
    x[ph - 1] = u[ph - 1]
    for k in range(ph - 2, -1, -1):
        x[k] = u[k] - mv(Sinv[:, k], vm(x[k + 1], L[:, k]))
    xs = torch.stack([x[k] - mv(X[:, k], g) for k in range(ph)], dim=1)
    return xs, g


# -- wrappers -----------------------------------------------------------------
def _check(name, t, shape, dtype, device):
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, got {tuple(t.shape)}")
    if t.dtype != dtype or t.device != device:
        raise TypeError(f"{name}: expected {dtype} on {device}, got {t.dtype} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def batched_factor(D, L, C, G, bs_p: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched bordered block-tridiagonal quasi-definite factorization.

    ``D`` (B, ph, bs, bs), ``L`` (B, ph-1, bs, bs), ``C`` (B, ph, bs, w),
    ``G`` (B, w, w) -> (Sinv (B, ph, bs, bs), X (B, ph, bs, w), Ghat
    (B, w, w)); the caller inverts ``Ghat``.  CPU tensors run the twin; CUDA
    tensors launch the kernel on the current stream and count the launch in
    ``batched_factor.launches``.
    """
    if D.device.type == "cpu":
        return traj_factor_plain(D, L, C, G, bs_p)
    if D.device.type != "cuda":
        raise ValueError(f"traj_factor kernel: unsupported device {D.device}")
    if D.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"traj_factor kernel takes float32/float64, got {D.dtype}")
    if D.dim() != 4 or D.shape[2] != D.shape[3] or C.dim() != 4:
        raise ValueError(f"traj_factor takes D (B, ph, bs, bs), got {tuple(D.shape)}")
    B, ph, bs, _ = D.shape
    w = C.shape[-1]
    if not factor_supported(ph, bs, bs_p, w, D.dtype):
        raise ValueError(
            f"traj_factor kernel: ph={ph}, bs={bs}, bs_p={bs_p}, w={w} "
            f"({D.dtype}) needs {factor_smem_bytes(bs, bs_p, w, D.dtype)} bytes of "
            f"shared memory per instance; a block has {SMEM_LIMIT_BYTES}")
    _check("D", D, (B, ph, bs, bs), D.dtype, D.device)
    _check("L", L, (B, ph - 1, bs, bs), D.dtype, D.device)
    _check("C", C, (B, ph, bs, w), D.dtype, D.device)
    _check("G", G, (B, w, w), D.dtype, D.device)
    Sinv = torch.empty_like(D)
    X = torch.empty_like(C)
    Ghat = torch.empty_like(G)
    if B == 0:
        return Sinv, X, Ghat
    lib = _build.library()
    fn = lib.libmpc_traj_factor_f32 if D.dtype == torch.float32 else lib.libmpc_traj_factor_f64
    with torch.cuda.device(D.device):
        stream = torch.cuda.current_stream(D.device).cuda_stream
        code = fn(D.data_ptr(), L.data_ptr(), C.data_ptr(), G.data_ptr(),
                  Sinv.data_ptr(), X.data_ptr(), Ghat.data_ptr(),
                  B, ph, bs, bs_p, w, FACTOR_THREADS, stream)
    _build.check(code, "traj_factor kernel launch")
    batched_factor.launches += 1
    return Sinv, X, Ghat


batched_factor.launches = 0


def batched_sweep_solve(Sinv, L, X, Ghat_inv, r_stage, r_g) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched bordered block-tridiagonal solve.

    ``Sinv`` (B, ph, bs, bs), ``L`` (B, ph-1, bs, bs), ``X`` (B, ph, bs, w),
    ``Ghat_inv`` (B, w, w), ``r_stage`` (B, ph, bs), ``r_g`` (B, w) ->
    (``xs`` (B, ph, bs), ``g`` (B, w)).  CPU tensors run the twin; CUDA
    tensors launch the kernel on the current stream and count the launch in
    ``batched_sweep_solve.launches``.
    """
    if Sinv.device.type == "cpu":
        return traj_solve_plain(Sinv, L, X, Ghat_inv, r_stage, r_g)
    if Sinv.device.type != "cuda":
        raise ValueError(f"traj_sweep kernel: unsupported device {Sinv.device}")
    if Sinv.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"traj_sweep kernel takes float32/float64, got {Sinv.dtype}")
    if Sinv.dim() != 4 or Sinv.shape[2] != Sinv.shape[3] or X.dim() != 4:
        raise ValueError(f"traj_sweep takes Sinv (B, ph, bs, bs), got {tuple(Sinv.shape)}")
    B, ph, bs, _ = Sinv.shape
    w = X.shape[-1]
    dtype, dev = Sinv.dtype, Sinv.device
    if not sweeps_supported(ph, bs, w, dtype):
        raise ValueError(
            f"traj_sweep kernel: ph={ph}, bs={bs}, w={w} ({dtype}) needs "
            f"{sweep_smem_bytes(ph, bs, w, dtype)} bytes of shared memory per instance; "
            f"a block has {SMEM_LIMIT_BYTES}")
    _check("Sinv", Sinv, (B, ph, bs, bs), dtype, dev)
    _check("L", L, (B, ph - 1, bs, bs), dtype, dev)
    _check("X", X, (B, ph, bs, w), dtype, dev)
    _check("Ghat_inv", Ghat_inv, (B, w, w), dtype, dev)
    _check("r_stage", r_stage, (B, ph, bs), dtype, dev)
    _check("r_g", r_g, (B, w), dtype, dev)
    xs = torch.empty_like(r_stage)
    g = torch.empty_like(r_g)
    if B == 0:
        return xs, g
    lib = _build.library()
    fn = lib.libmpc_traj_sweep_f32 if dtype == torch.float32 else lib.libmpc_traj_sweep_f64
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(Sinv.data_ptr(), L.data_ptr(), X.data_ptr(), Ghat_inv.data_ptr(),
                  r_stage.data_ptr(), r_g.data_ptr(), xs.data_ptr(), g.data_ptr(),
                  B, ph, bs, w, SWEEP_WARPS, stream)
    _build.check(code, "traj_sweep kernel launch")
    batched_sweep_solve.launches += 1
    return xs, g


batched_sweep_solve.launches = 0
