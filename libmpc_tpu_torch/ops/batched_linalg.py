"""Batched small dense linear algebra: the hand-written CUDA kernels K2 (SPD
inverse) and K6 (eigenvalue clipping), and their twins.

Counterpart of ``libmpc_tpu/ops/batched_linalg.py``.  :func:`chol_inverse`
inverts a batch of small SPD matrices (B, k, k):

* on a CUDA tensor it launches ``csrc/chol_inverse.cu`` (float32 or
  float64) at :func:`layout`'s choice, which replaces the Pallas kernel
  ``_chol_inv_kernel`` (``pallas_call`` at ``batched_linalg.py:110``);
* on a CPU tensor it runs :func:`chol_inverse_plain`, the plain twin:
  ``torch.linalg.cholesky`` then ``torch.cholesky_inverse``.

What bounds the kernel on an H100, and what its design does about it: at
the main path's shapes the bytes (each matrix's lower triangle read once
and its inverse written once) set the least time, while the arithmetic is
a few chains of k dependent steps a matrix whose broadcasts cost shuffles
(measured in ``PERF.md``: 2.2x the bound at (16384, 24, 24) in float32).
The TPU's batch-in-lanes layout does not carry over.  The kernel has two tiers, and :func:`layout` is the one place that
chooses between them (the launcher only checks its choice):

* the register tier (k <= 32): ``g`` lanes a matrix, each holding rows
  t, t + g, ... of the lower triangle in registers through the factor, the
  triangular inverse and the outer products, with the broadcasts of each
  step as warp shuffles inside the group; a large batch's output goes out
  through shared memory as one contiguous copy (``stage``).  ``g``
  (:func:`register_g`) is the most lanes that share the rows without
  padding the matrix further, with 32 elements a lane at least and within
  ``REG_WORDS`` 32-bit registers a lane; the kernel exists for the padded
  sizes and lane counts of ``REG_INSTANCES``;
* the block tier (33 <= k <= 64; any k when forced): one block a matrix,
  the block-parallel factor and triangular inverse of ``chol_block.cuh``
  and X = Yt Yt' as register tiles.

Past k = 64 :func:`chol_inverse_blocked` runs the 2x2 block Schur recursion
of ``batched_linalg.py:125`` (``_chol_inverse_blocked``): the 48-wide
diagonal blocks go through the kernel, the off-diagonal products are
``torch.bmm`` (the JAX package computes those outside its Pallas kernel
too).

:func:`spd_inverse` and :func:`spd_solve` are batch-first: an unbatched
(n, n) matrix uses ``torch.linalg.cholesky`` (XLA's Cholesky in the JAX
package; through ``_host.cholesky``, which counts its status read), a
batched one routes to :func:`chol_inverse` or, on the card past the
kernel's gate, to :func:`chol_inverse_blocked`.  Their callers are the
SQP's second-order correction (``ops/sqp.py``, k = me), the float32 interior
point (``ops/pdip.py``, k = nz + 1 and k = me), the border Schur complement
of the banded-KKT factorization (``ops/trajectory_kkt.py``, k = nu + 2) and
the LMPC polish (``ops/admm.py``, k = 24 at the quadrotor shape).  The
per-instance ADMM of the SQP's ``"admm"`` engine (``ops/admm.py``,
``admm_solve_each``) calls :func:`chol_inverse` itself for its KKT inverses
(k = nz, 61 at the UGV shape) and its polish capacitance (k = 24), and
:func:`chol_inverse_blocked` past k = 64.

:func:`eig_clip` clips the eigenvalues of a batch of symmetric matrices
(B, n, n) to a floor, the SQP's exact-Hessian ``"eigh"`` curvature
(``ops/sqp.py::_eigh_convexify``).  On a CUDA tensor within its shared-memory
tier it launches K6, ``csrc/eig_clip.cu`` (one block a lane, parallel cyclic
Jacobi, the clipped matrix rebuilt in the same block), which replaces no
Pallas kernel: the JAX package calls ``jnp.linalg.eigh``.  Elsewhere it runs
:func:`eig_clip_plain`, ``torch.linalg.eigh`` and the clip, as before K6.
"""

from __future__ import annotations

import functools
from collections import namedtuple

import torch

from . import _build, _host

MAX_K = 64
# diagonal-block width of the blocked recursion (the JAX package's _BLOCK_K)
BLOCK_K = 48
H100_SMS = 132

TIER_REGISTER, TIER_BLOCK = 0, 1
REG_MAX_K = 32
# registers (32-bit words) a lane may spend on its rows of the matrix
REG_WORDS = {torch.float32: 96, torch.float64: 128}
# the register tier's (padded size KP, lanes a matrix g) instances: the
# layout's choices, no others (LIBMPC_K2_REG_F32 / _F64 of
# csrc/chol_inverse.cu; a card test holds these rules to the library's)
REG_INSTANCES = {
    torch.float32: frozenset({(4, 1), (8, 2), (12, 4), (16, 8), (20, 4), (24, 8), (32, 8)}),
    torch.float64: frozenset({(4, 1), (8, 2), (12, 4), (16, 8), (20, 4), (24, 8), (32, 16)}),
}
REG_MAX_THREADS = 128
BLOCK_THREADS = 128
BLOCK_THREADS_RANGE = (64, 256)

# the register tier stages its output through shared memory from this many
# bytes of output on (below it the time is latency, and the staging's extra
# step costs more than the scattered stores it saves)
STAGE_MIN_BYTES = 1 << 20

Layout = namedtuple("Layout", "tier g kp threads grid stage smem_bytes")
Layout.__doc__ = """A launch's layout: ``tier`` (``TIER_REGISTER`` or
``TIER_BLOCK``), ``g`` lanes a matrix (0 in the block tier), ``kp`` the
padded size the register kernel is built for (k in the block tier),
``threads`` a block, ``grid`` blocks, ``stage`` 1 where the register tier
copies its output out through shared memory (0 otherwise), dynamic shared
memory a block in bytes."""


def kernel_supported(k: int) -> bool:
    """Whether the CUDA kernel takes matrix dimension ``k``."""
    return 1 <= k <= MAX_K


def _elem(dtype: torch.dtype) -> int:
    return torch.finfo(dtype).bits // 8


def padded_k(k: int, g: int) -> int:
    """The size the register kernel runs ``k`` at with ``g`` lanes a matrix:
    k rounded up to a multiple of max(4, g) (rows past k are the identity's)."""
    m = max(4, g)
    return -(-k // m) * m


def register_words(kp: int, g: int, dtype: torch.dtype) -> int:
    """32-bit registers a lane holds its rows in: rows t, t + g, ... of a
    kp x kp lower triangle, slot s keeping (s + 1) g positions."""
    r = kp // g
    return g * r * (r + 1) // 2 * _elem(dtype) // 4


def register_g(k: int, dtype: torch.dtype) -> int:
    """Lanes a matrix in the register tier: the most (at most 8) that divide
    k rounded up to 4 and leave a lane 32 elements of the matrix at least,
    where a lane's share fits ``REG_WORDS[dtype]`` registers: more lanes
    shorten each lane's part of every step, and past that share the
    shuffles of a step outweigh it (measured at k = 8, 20 and 24: PERF.md);
    where none fits, the fewest lanes whose share of the padded matrix
    fits."""
    kp = padded_k(k, 4)
    for g in (8, 4, 2, 1):
        if (kp % g == 0 and (g == 1 or kp * kp >= 32 * g)
                and register_words(kp, g, dtype) <= REG_WORDS[dtype]):
            return g
    for g in (1, 2, 4, 8, 16):
        if register_words(padded_k(k, g), g, dtype) <= REG_WORDS[dtype]:
            return g
    raise ValueError(f"no register layout for k={k}")


def stage_stride(k: int, g: int, dtype: torch.dtype) -> int:
    """Elements between two matrices in a warp's staging area of the
    register tier: k^2 and the least pad (a multiple of 16 bytes) that puts
    consecutive matrices ``g`` banks apart, where one exists
    (``stage_stride`` of ``csrc/chol_inverse.cu``)."""
    elem = _elem(dtype)
    v, wpe = 16 // elem, elem // 4
    for p in range(0, 32, v):
        if ((k * k + p) * wpe) % 32 == (g * wpe) % 32:
            return k * k + p
    return k * k


def block_smem_bytes(k: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of a block-tier block: the matrix and (L^-1)',
    rows of k | 1 elements, and 2 k pivot reciprocals."""
    return (2 * k * (k | 1) + 2 * k) * _elem(dtype)


def register_layout(B: int, k: int, dtype: torch.dtype, g: int | None = None,
                    threads: int | None = None, stage: bool | None = None,
                    sms: int = H100_SMS) -> Layout | None:
    """A register-tier launch for (B, k): ``g`` lanes a matrix (None:
    :func:`register_g`), ``threads`` a block (None: 128 where the batch
    fills four warps an SM, else 32, so that a small batch spreads over the
    SMs) and ``stage`` (None: from ``STAGE_MIN_BYTES`` of output on).  None
    where the tier does not take k or no instance exists."""
    if not 1 <= k <= REG_MAX_K:
        return None
    g = register_g(k, dtype) if g is None else g
    kp = padded_k(k, g)
    if (kp, g) not in REG_INSTANCES[dtype]:
        return None
    if threads is None:
        warps = -(-B * g // 32)
        threads = REG_MAX_THREADS if warps >= 4 * sms else 32
    if stage is None:
        stage = B * k * k * _elem(dtype) >= STAGE_MIN_BYTES
    per_block = threads // g
    smem = per_block * stage_stride(k, g, dtype) * _elem(dtype) if stage else 0
    return Layout(TIER_REGISTER, g, kp, threads, -(-B // per_block), int(stage), smem)


def block_layout(B: int, k: int, dtype: torch.dtype, threads: int = BLOCK_THREADS) -> Layout:
    """A block-tier launch for (B, k): one block of ``threads`` a matrix."""
    return Layout(TIER_BLOCK, 0, k, threads, B, 0, block_smem_bytes(k, dtype))


@functools.lru_cache(maxsize=256)
def layout(B: int, k: int, dtype: torch.dtype, sms: int = H100_SMS) -> Layout:
    """The layout :func:`chol_inverse` launches: the register tier for
    k <= 32, the block tier for 33 <= k <= 64.  Raises ``ValueError`` past
    the kernel's gate."""
    if not kernel_supported(k):
        raise ValueError(f"chol_inverse kernel takes k <= {MAX_K}, got k={k}")
    if k <= REG_MAX_K:
        return register_layout(B, k, dtype, sms=sms)
    return block_layout(B, k, dtype)


def chol_inverse_plain(C):
    """Inverse of a batch of SPD matrices by Cholesky (the kernel's twin).

    A matrix whose factorization fails comes back as NaN, as XLA's Cholesky
    reports it in the JAX package."""
    L, info = torch.linalg.cholesky_ex(C)
    inv = torch.cholesky_inverse(L)
    return torch.where((info != 0)[..., None, None], float("nan"), inv)


def _check(C):
    if C.device.type != "cuda":
        raise ValueError(f"chol_inverse kernel: unsupported device {C.device}")
    if C.dtype not in REG_WORDS:
        raise TypeError(f"chol_inverse kernel takes float32/float64, got {C.dtype}")
    if C.dim() != 3 or C.shape[1] != C.shape[2]:
        raise ValueError(f"chol_inverse takes (B, k, k), got {tuple(C.shape)}")
    if not kernel_supported(C.shape[1]):
        raise ValueError(f"chol_inverse kernel takes k <= {MAX_K}, got k={C.shape[1]}")
    if not C.is_contiguous():
        raise ValueError("chol_inverse: C must be contiguous")


@functools.lru_cache(maxsize=None)
def _sms(index) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def chol_inverse(C):
    """Inverse of a batch of small SPD matrices ``C`` (B, k, k).

    CPU tensors run the plain twin; CUDA tensors launch the kernel on the
    current stream at :func:`layout`'s choice and count the launch in
    ``chol_inverse.launches``.  ``chol_inverse.trace``, when a list,
    collects (B, k, dtype) of every launch.
    """
    if C.device.type == "cpu":
        return chol_inverse_plain(C)
    _check(C)
    B, k, _ = C.shape
    return _launch(layout(B, k, C.dtype, _sms(C.device.index)), C)


def launch(lay: Layout, C):
    """Launch the kernel on a CUDA tensor with the layout ``lay`` in place of
    :func:`layout`'s choice (the card tests and timing sweeps force a tier or
    a lane count so).  The launcher refuses, and this raises, a layout that
    does not apply to (B, k) and the type."""
    _check(C)
    return _launch(lay, C)


_fns: dict = {}


def _stream(index) -> int:
    """The current stream's handle on device ``index``, without building a
    ``torch.cuda.Stream`` (a few us a call less)."""
    return torch._C._cuda_getCurrentRawStream(index)


def _call(stem, t, *args):
    """The library's entry ``libmpc_<stem>_f32`` or ``_f64`` (by ``t``'s type)
    called with ``args`` and the current stream of ``t``'s device; returns
    its CUDA error code."""
    fn = _fns.get((stem, t.dtype))
    if fn is None:
        name = f"libmpc_{stem}_{'f32' if t.dtype == torch.float32 else 'f64'}"
        fn = _fns.setdefault((stem, t.dtype), getattr(_build.library(), name))
    index = t.device.index
    if index == torch.cuda.current_device():
        return fn(*args, _stream(index))
    with torch.cuda.device(index):
        return fn(*args, _stream(index))


def _launch(lay, C):
    """One launch on the current stream, counted in ``chol_inverse.launches``."""
    B, k, _ = C.shape
    out = torch.empty_like(C)
    if B == 0:
        return out
    code = _call("chol_inverse", C, C.data_ptr(), out.data_ptr(), B, k, lay.tier, lay.g,
                 lay.threads, lay.stage)
    if code != 0:
        _build.check(code, f"chol_inverse kernel launch with {lay}")
    chol_inverse.launches += 1
    if chol_inverse.trace is not None:
        chol_inverse.trace.append((B, k, C.dtype))
    return out


chol_inverse.launches = 0
chol_inverse.trace = None


def chol_inverse_blocked(C, block_k: int = BLOCK_K, leaf_k: int = MAX_K):
    """Explicit inverse of a batch of SPD matrices (B, k, k) of any k by 2x2
    block Schur recursion: a matrix of k <= ``leaf_k`` goes to
    :func:`chol_inverse`; a larger one splits off its leading ``block_k``
    diagonal block, inverts it the same way, recurses on the symmetrized
    Schur complement, and does everything else as batched matrix products::

        [A  B]^-1  =  [Ai + AiB Si AiB'   -AiB Si]
        [B' D]        [   -Si AiB'            Si ],
        Ai = A^-1,  S = D - B' Ai B,  Si = S^-1,  AiB = Ai B.

    On the card the leaves launch the kernel (``block_k <= leaf_k <= 64``);
    on the CPU they run the twin, which a test drives with small blocks.
    """
    k = C.shape[-1]
    if not 1 <= block_k <= leaf_k:
        raise ValueError(f"need 1 <= block_k <= leaf_k, got {block_k}, {leaf_k}")
    if k <= leaf_k:
        return chol_inverse(C.contiguous())
    A = C[:, :block_k, :block_k]
    Bb = C[:, :block_k, block_k:]
    D = C[:, block_k:, block_k:]
    Ai = chol_inverse_blocked(A, block_k, leaf_k)
    AiB = Ai @ Bb
    S = D - Bb.transpose(1, 2) @ AiB
    Si = chol_inverse_blocked(0.5 * (S + S.transpose(1, 2)), block_k, leaf_k)
    AiBSi = AiB @ Si
    top = torch.cat([Ai + AiBSi @ AiB.transpose(1, 2), -AiBSi], dim=2)
    bot = torch.cat([-AiBSi.transpose(1, 2), Si], dim=2)
    return torch.cat([top, bot], dim=1)


def _batched_inverse(M):
    if M.device.type == "cuda" and not kernel_supported(M.shape[-1]):
        return chol_inverse_blocked(M)
    return chol_inverse(M)


def spd_inverse(M):
    """Explicit inverse of an SPD matrix (n, n), or of a batch (B, k, k)."""
    if M.dim() == 2:
        return torch.cholesky_inverse(_host.cholesky(M))
    return _batched_inverse(M)


def spd_solve(M, rhs):
    """Solve ``M x = rhs`` for SPD ``M``: (n, n) with (n,), or a batch
    (B, k, k) with (B, k)."""
    if M.dim() == 2:
        L = _host.cholesky(M)
        return torch.cholesky_solve(rhs[:, None], L)[:, 0]
    return torch.einsum("bij,bj->bi", _batched_inverse(M), rhs.to(M.dtype)).to(rhs.dtype)


# -- eigenvalue clipping: K6 ---------------------------------------------------

EIG_SMEM_LIMIT = 232448  # the dynamic shared memory a block can use


def eig_clip_smem_bytes(n: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one K6 block at size n (``smem_bytes`` of
    ``csrc/eig_clip.cu``): A and V padded to an even n_p with rows of
    n_p + 1, four arrays of n_p / 2 rotation values, 32 reduction slots and
    two arrays of n_p / 2 pair indices (4 bytes each)."""
    n_p = n + (n & 1)
    half = n_p // 2
    return (2 * n_p * (n_p + 1) + 4 * half + 32) * _elem(dtype) + 2 * half * 4


def eig_clip_supported(n: int, dtype: torch.dtype) -> bool:
    """Whether K6 takes (B, n, n) of ``dtype``: float32 or float64, and the
    lane's block within shared memory (n <= 168 in float32, n <= 118 in
    float64)."""
    return (dtype in REG_WORDS and n >= 1
            and eig_clip_smem_bytes(n, dtype) <= EIG_SMEM_LIMIT)


def eig_clip_plain(H):
    """The clipped convex model of a batch of symmetric matrices H (B, n, n):
    V diag(max(w, tau)) V' with tau = max(1e-8, 1e-6 max|w|) per lane, through
    ``torch.linalg.eigh`` (``_host.eigh``, which reads its status back): K6's
    twin, and the route past its shared-memory tier."""
    w, V = _host.eigh(H)
    tau = torch.clamp(1e-6 * torch.amax(torch.abs(w), dim=-1), min=1e-8)
    return (V * torch.maximum(w, tau[:, None])[:, None, :]) @ V.transpose(1, 2)


def eig_clip(H):
    """The clipped convex model of a batch of symmetric matrices H (B, n, n)
    (:func:`eig_clip_plain`'s function).

    A CUDA tensor whose n the kernel takes (:func:`eig_clip_supported`)
    launches K6 (``csrc/eig_clip.cu``) on the current stream, one block a
    lane, and reads nothing back; the launch is counted in
    ``eig_clip.launches`` and, where ``eig_clip.trace`` is a list, each lane's
    Jacobi sweeps (a (B,) int32 tensor on the card) are appended to it.  A
    lane with a non-finite entry comes back as NaN.  Every other tensor runs
    the twin.
    """
    if (H.device.type != "cuda" or H.dim() != 3 or H.shape[1] != H.shape[2]
            or not eig_clip_supported(H.shape[-1], H.dtype)):
        return eig_clip_plain(H)
    return _eig_clip_launch(H.contiguous())


def _eig_clip_launch(H, threads: int = 0):
    """One K6 launch on the current stream (``threads`` a block, 0 for the
    kernel's own choice); returns the output."""
    B, n, _ = H.shape
    out = torch.empty_like(H)
    sweeps = torch.empty((B,), dtype=torch.int32, device=H.device)
    code = _call("eig_clip", H, H.data_ptr(), out.data_ptr(), sweeps.data_ptr(), B, n, threads)
    if code != 0:
        _build.check(code, f"eig_clip kernel launch at B={B}, n={n}, threads={threads}")
    eig_clip.launches += 1
    if eig_clip.trace is not None:
        eig_clip.trace.append(sweeps)
    return out


eig_clip.launches = 0
eig_clip.trace = None
