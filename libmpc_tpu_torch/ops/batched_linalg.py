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
solves) in parallel.  It takes k <= 64 (:func:`kernel_supported`); the
blocked Schur recursion the JAX package uses past its own gate is not
ported yet, so a larger batched system on the card raises.

:func:`spd_inverse` and :func:`spd_solve` are batch-first: an unbatched
(n, n) matrix uses ``torch.linalg.cholesky`` (XLA's Cholesky in the JAX
package), a batched one routes to :func:`chol_inverse`.  Their callers are
the SQP's second-order correction (``ops/sqp.py``, k = me) and the float32
interior point (``ops/pdip.py``, k = nz + 1 and k = me).
"""

from __future__ import annotations

import torch

from . import _build

MAX_K = 64


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


def _batched_inverse(M):
    if M.device.type == "cuda" and not kernel_supported(M.shape[-1]):
        raise NotImplementedError(
            f"batched SPD inverse of k={M.shape[-1]} > {MAX_K} on the card: the "
            "blocked Schur recursion of libmpc_tpu/ops/batched_linalg.py:125 is "
            "not ported yet (ROADMAP.md queue 1: K2's blocked recursion)"
        )
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
