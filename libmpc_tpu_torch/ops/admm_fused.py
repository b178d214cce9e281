"""Fused ADMM iteration blocks: the hand-written CUDA kernel and its twin.

Counterpart of ``libmpc_tpu/ops/admm_pallas.py``.  :func:`fused_iterations`
runs ``k_iters`` ADMM iterations for a batch that shares A, M, Minv and rho:

* on a CUDA tensor it launches ``csrc/admm_fused.cu`` (float32 or float64),
  which replaces the Pallas kernel ``admm_pallas.py::_kernel``
  (``pallas_call`` at ``admm_pallas.py:143``);
* on a CPU tensor it runs :func:`plain_iterations`, the plain PyTorch twin:
  ``one_iteration`` of ``libmpc_tpu/ops/admm.py:416-443`` looped ``k_iters``
  times.

What bounds the kernel on an H100, and what its design does about it: the
TPU kernel keeps A (m, n), M and Minv (n, n) in VMEM; at the quadrotor size
that is 836 KB in float32, beyond the 227 KB of shared memory of a Hopper
block.  The CUDA kernel instead keeps a tile of ``bt`` lanes' x/z/y and
scratch resident in shared memory for all ``k_iters`` iterations and streams
the shared matrices from L2, reusing each fetched element for all ``bt``
lanes; its shared-memory need is ``(3 n + 2 m + max(n, m)) bt`` elements,
which :func:`pick_tile` checks against the card's 227 KB per block.
"""

from __future__ import annotations

import torch

from . import _build

SMEM_LIMIT_BYTES = 232448  # dynamic shared memory one Hopper block can use
_PREFERRED_TILE = {torch.float32: 8, torch.float64: 4}


def plain_iterations(x, z, y, done, q, l, u, A, M, Minv, rho_vec, *,
                     sigma: float, alpha: float, k_iters: int,
                     refine: bool = True):
    """``k_iters`` ADMM iterations in plain PyTorch (the kernel's twin).

    Shapes: x/q (B, n); z/y/l/u (B, m); done (B,) bool; A (m, n);
    M/Minv (n, n); rho_vec (m,).  Returns the updated (x, z, y).
    """
    frozen = done[:, None]
    for _ in range(k_iters):
        # x-update: (P + sigma I + A' R A) xt = sigma x - q + A'(R z - y)
        rhs = sigma * x - q + (rho_vec * z - y) @ A
        xt = rhs @ Minv  # Minv symmetric
        if refine:
            # one refinement pass against M recovers the digits the
            # explicit float32 inverse loses
            xt = xt + (rhs - xt @ M) @ Minv
        zt = xt @ A.T
        x_new = alpha * xt + (1.0 - alpha) * x
        z_relax = alpha * zt + (1.0 - alpha) * z
        z_unc = z_relax + y / rho_vec
        z_new = torch.clamp(z_unc, min=l, max=u)
        # y is exactly zero on rows where the projection did not clip
        clipped = (z_unc < l) | (z_unc > u)
        y_new = torch.where(clipped, y + rho_vec * (z_relax - z_new), 0.0)
        x = torch.where(frozen, x, x_new)
        z = torch.where(frozen, z, z_new)
        y = torch.where(frozen, y, y_new)
    return x, z, y


def smem_bytes(bt: int, n: int, m: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one kernel block: x, rhs and xt (n each),
    z and y (m each), and w, whose buffer the refinement residual reuses
    (max(n, m)), per lane."""
    return (3 * n + 2 * m + max(n, m)) * bt * torch.finfo(dtype).bits // 8


def pick_tile(n: int, m: int, dtype: torch.dtype) -> int:
    """Lanes per block: the preferred tile (8 in float32, 4 in float64: three
    blocks per SM at the quadrotor size), halved until the block's shared
    memory fits; raises when not even one lane fits."""
    bt = _PREFERRED_TILE[dtype]
    while bt >= 1:
        if smem_bytes(bt, n, m, dtype) <= SMEM_LIMIT_BYTES:
            return bt
        bt //= 2
    raise ValueError(
        f"fused ADMM kernel: n={n}, m={m} needs {smem_bytes(1, n, m, dtype)} "
        f"bytes of shared memory per lane, over the {SMEM_LIMIT_BYTES} a "
        "block can use"
    )


def _check(x, z, y, done, q, l, u, A, M, Minv, rho_vec):
    if x.dtype not in _PREFERRED_TILE:
        raise TypeError(f"fused ADMM kernel takes float32/float64, got {x.dtype}")
    B, n = x.shape
    m = A.shape[0]
    expect = {
        "x": (x, (B, n)), "z": (z, (B, m)), "y": (y, (B, m)),
        "q": (q, (B, n)), "l": (l, (B, m)), "u": (u, (B, m)),
        "A": (A, (m, n)), "M": (M, (n, n)), "Minv": (Minv, (n, n)),
        "rho_vec": (rho_vec, (m,)),
    }
    for name, (t, shape) in expect.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
        if t.dtype != x.dtype:
            raise TypeError(f"{name}: dtype {t.dtype}, expected {x.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if done.shape != (B,) or done.dtype != torch.bool or done.device != x.device:
        raise ValueError("done must be a (B,) bool tensor on x's device")


def fused_iterations(x, z, y, done, q, l, u, A, M, Minv, rho_vec, *,
                     sigma: float, alpha: float, k_iters: int,
                     refine: bool = True):
    """Run ``k_iters`` ADMM iterations for the whole batch.

    Shapes as :func:`plain_iterations`.  CPU tensors run the plain twin; CUDA
    tensors launch the kernel (float32 or float64) on the current stream and
    count the launch in ``fused_iterations.launches``.
    """
    if x.device.type == "cpu":
        return plain_iterations(
            x, z, y, done, q, l, u, A, M, Minv, rho_vec, sigma=sigma,
            alpha=alpha, k_iters=k_iters, refine=refine,
        )
    if x.device.type != "cuda":
        raise ValueError(f"fused ADMM kernel: unsupported device {x.device}")
    _check(x, z, y, done, q, l, u, A, M, Minv, rho_vec)
    B, n = x.shape
    m = A.shape[0]
    bt = pick_tile(n, m, x.dtype)
    if B == 0 or k_iters == 0:
        return x.clone(), z.clone(), y.clone()
    ox, oz, oy = torch.empty_like(x), torch.empty_like(z), torch.empty_like(y)
    lib = _build.library()
    fn = (lib.libmpc_admm_fused_f32 if x.dtype == torch.float32
          else lib.libmpc_admm_fused_f64)
    At = A.t().contiguous()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = fn(
            x.data_ptr(), z.data_ptr(), y.data_ptr(), done.data_ptr(),
            q.data_ptr(), l.data_ptr(), u.data_ptr(), A.data_ptr(),
            At.data_ptr(), M.data_ptr(), Minv.data_ptr(), rho_vec.data_ptr(),
            ox.data_ptr(), oz.data_ptr(), oy.data_ptr(),
            B, n, m, int(k_iters), float(sigma), float(alpha), int(bool(refine)),
            bt, stream,
        )
    _build.check(code, "admm_fused kernel launch")
    fused_iterations.launches += 1
    return ox, oz, oy


fused_iterations.launches = 0
