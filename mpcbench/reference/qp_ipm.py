"""A plain batched interior-point solver for small dense convex QPs.

    minimize   1/2 u' H u + g' u
    subject to G u <= h

``H`` (n, n) positive definite, ``g`` (B, n), ``G`` (p, n) or (B, p, n),
``h`` (B, p).  Mehrotra's predictor-corrector on the normal equations
``(H + G' W G) du = r`` with ``W = lambda / s``, each step 0.95 of the way
to the boundary, a fixed number of iterations for the whole batch; a lane
stops moving once it has converged.  Written from the textbook method with
plain ``torch`` operations only: it shares no code with the solvers under
test.

The working precision is the tensors' dtype.  ``tf32=True`` lets float32
matrix products run in TF32 on the card, the precision the benchmark's
control computes in.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """TF32 matrix products on (``tf32``) or off inside the block."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _bmv(M, v):
    """(shared or B, r, c) @ (B, c) -> (B, r)."""
    if M.dim() == 2:
        return v @ M.T
    return torch.bmm(M, v[:, :, None])[:, :, 0]


def _bmtv(M, v):
    """(shared or B, r, c)' @ (B, r) -> (B, c)."""
    if M.dim() == 2:
        return v @ M
    return torch.bmm(M.transpose(1, 2), v[:, :, None])[:, :, 0]


def _step_to_boundary(v, dv):
    """Largest alpha in (0, 1] with v + alpha dv >= 0 lane by lane."""
    ratio = torch.where(dv < 0, -v / dv, torch.full_like(v, float("inf")))
    return torch.clamp(ratio.amin(dim=1), max=1.0)


def floor(dtype, tf32: bool = False) -> float:
    """The tolerance a lane converges to, relative to the data's scale: 1e-9
    in float64; in float32, 32 unit roundoffs of its products (2**-24, or
    TF32's 2**-11), which every lane can reach in that precision."""
    if dtype == torch.float64:
        return 1e-9
    return 32 * 2.0 ** (-11 if tf32 else -24)


def solve(H, g, G, h, iters: int = 100, tf32: bool = False):
    """Solve the batch; returns (u (B, n), converged (B,) bool).

    ``converged`` holds where the duality measure and both residuals are
    below :func:`floor` relative to the data's scale."""
    B, n = g.shape
    p = h.shape[1]
    dt = g.dtype
    tol_rel = floor(dt, tf32)
    with matmul_precision(tf32):
        u = torch.zeros((B, n), dtype=dt, device=g.device)
        s = torch.clamp(h - _bmv(G, u), min=1.0)
        lam = torch.ones((B, p), dtype=dt, device=g.device)
        scale = 1.0 + g.abs().amax(dim=1) + h.abs().amax(dim=1)

        def converged(u, s, lam):
            rd = _bmv(H, u) + g + _bmtv(G, lam)
            rp = _bmv(G, u) + s - h
            mu = (s * lam).mean(dim=1)
            tol = tol_rel * scale
            return ((mu < tol) & (rd.abs().amax(dim=1) < tol) & (rp.abs().amax(dim=1) < tol)
                    & torch.isfinite(u).all(dim=1)), rd, rp

        for _ in range(iters):
            conv, rd, rp = converged(u, s, lam)
            mu = (s * lam).mean(dim=1, keepdim=True)
            w = lam / s
            if G.dim() == 2:
                K = H + torch.einsum("pi,bp,pj->bij", G, w, G)
            else:
                K = H + torch.bmm(G.transpose(1, 2), w[:, :, None] * G)
            L, info = torch.linalg.cholesky_ex(K)

            def direction(rc):
                rhs = -rd - _bmtv(G, w * rp - rc / s)
                du = torch.cholesky_solve(rhs[:, :, None], L)[:, :, 0]
                dlam = w * (_bmv(G, du) + rp) - rc / s
                ds = -(rc + s * dlam) / lam
                return du, ds, dlam

            # predictor (affine scaling), then Mehrotra's corrector
            du, ds, dlam = direction(s * lam)
            a = torch.minimum(_step_to_boundary(s, ds), _step_to_boundary(lam, dlam))[:, None]
            mu_aff = ((s + a * ds) * (lam + a * dlam)).mean(dim=1, keepdim=True)
            sigma = (mu_aff / mu) ** 3
            du, ds, dlam = direction(s * lam + ds * dlam - sigma * mu)
            a = 0.95 * torch.minimum(_step_to_boundary(s, ds),
                                     _step_to_boundary(lam, dlam))[:, None]
            # a lane moves while it has not converged and its step is sound
            move = (~conv & (info == 0))[:, None]
            move = move & torch.isfinite(du).all(dim=1, keepdim=True) \
                & torch.isfinite(ds).all(dim=1, keepdim=True) \
                & torch.isfinite(dlam).all(dim=1, keepdim=True)
            u = torch.where(move, u + a * du, u)
            s = torch.where(move, s + a * ds, s)
            lam = torch.where(move, lam + a * dlam, lam)
        conv, _, _ = converged(u, s, lam)
    return u, conv
