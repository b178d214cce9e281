"""Batched small dense SPD linear algebra: the hand-written CUDA inverse
kernel and its twin.

Counterpart of ``libmpc_tpu/ops/batched_linalg.py``.  :func:`chol_inverse`
inverts a batch of small SPD matrices (B, k, k):

* on a CUDA tensor it launches ``csrc/chol_inverse.cu`` (float32 or
  float64), which replaces the Pallas kernel ``_chol_inv_kernel``
  (``pallas_call`` at ``batched_linalg.py:110``);
* on a CPU tensor it runs :func:`chol_inverse_plain`, the plain twin:
  ``torch.linalg.cholesky`` then ``torch.cholesky_inverse``.

What bounds the kernel on an H100, and what its design does about it: each
factorization is a chain of k dependent steps on a few KB, so latency, not
bandwidth, sets its time.  The TPU's batch-in-lanes layout does not carry
over; the kernel gives each matrix one warp, which keeps it in shared
memory and works on its rows (factorization) and columns (triangular
solves) in parallel.  It takes k <= 64 (:func:`kernel_supported`); past
that :func:`chol_inverse_blocked` runs the 2x2 block Schur recursion of
``batched_linalg.py:125`` (``_chol_inverse_blocked``): the 48-wide diagonal
blocks go through the kernel, the off-diagonal products are ``torch.bmm``
(the JAX package computes those outside its Pallas kernel too).

:func:`spd_inverse` and :func:`spd_solve` are batch-first: an unbatched
(n, n) matrix uses ``torch.linalg.cholesky`` (XLA's Cholesky in the JAX
package), a batched one routes to :func:`chol_inverse` or, on the card past
the kernel's gate, to :func:`chol_inverse_blocked`.  Their callers are the
SQP's second-order correction (``ops/sqp.py``, k = me), the float32 interior
point (``ops/pdip.py``, k = nz + 1 and k = me) and the border Schur
complement of the banded-KKT factorization (``ops/trajectory_kkt.py``,
k = nu + 2).
"""

from __future__ import annotations

import torch

from . import _build

MAX_K = 64
# diagonal-block width of the blocked recursion (the JAX package's _BLOCK_K)
BLOCK_K = 48


def kernel_supported(k: int) -> bool:
    """Whether the CUDA kernel takes matrix dimension ``k``."""
    return 1 <= k <= MAX_K


def chol_inverse_plain(C):
    """Inverse of a batch of SPD matrices by Cholesky (the kernel's twin).

    A matrix whose factorization fails comes back as NaN, as XLA's Cholesky
    reports it in the JAX package."""
    L, info = torch.linalg.cholesky_ex(C)
    inv = torch.cholesky_inverse(L)
    return torch.where((info != 0)[..., None, None], float("nan"), inv)


def chol_inverse(C):
    """Inverse of a batch of small SPD matrices ``C`` (B, k, k).

    CPU tensors run the plain twin; CUDA tensors launch the kernel on the
    current stream and count the launch in ``chol_inverse.launches``.
    """
    if C.device.type == "cpu":
        return chol_inverse_plain(C)
    if C.device.type != "cuda":
        raise ValueError(f"chol_inverse kernel: unsupported device {C.device}")
    if C.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"chol_inverse kernel takes float32/float64, got {C.dtype}")
    if C.dim() != 3 or C.shape[1] != C.shape[2]:
        raise ValueError(f"chol_inverse takes (B, k, k), got {tuple(C.shape)}")
    B, k, _ = C.shape
    if not kernel_supported(k):
        raise ValueError(f"chol_inverse kernel takes k <= {MAX_K}, got k={k}")
    if not C.is_contiguous():
        raise ValueError("chol_inverse: C must be contiguous")
    out = torch.empty_like(C)
    if B == 0:
        return out
    lib = _build.library()
    fn = (lib.libmpc_chol_inverse_f32 if C.dtype == torch.float32
          else lib.libmpc_chol_inverse_f64)
    with torch.cuda.device(C.device):
        stream = torch.cuda.current_stream(C.device).cuda_stream
        code = fn(C.data_ptr(), out.data_ptr(), B, k, stream)
    _build.check(code, "chol_inverse kernel launch")
    chol_inverse.launches += 1
    return out


chol_inverse.launches = 0


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
        return torch.cholesky_inverse(torch.linalg.cholesky(M))
    return _batched_inverse(M)


def spd_solve(M, rhs):
    """Solve ``M x = rhs`` for SPD ``M``: (n, n) with (n,), or a batch
    (B, k, k) with (B, k)."""
    if M.dim() == 2:
        L = torch.linalg.cholesky(M)
        return torch.cholesky_solve(rhs[:, None], L)[:, 0]
    return torch.einsum("bij,bj->bi", _batched_inverse(M), rhs.to(M.dtype)).to(rhs.dtype)
