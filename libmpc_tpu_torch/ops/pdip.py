"""Primal-dual interior-point QP solver for small dense subproblems.

Port of ``libmpc_tpu/ops/pdip.py``, written batch-first: every argument
carries a leading batch axis and the Mehrotra predictor-corrector loop runs
on the host with a per-lane ``done`` mask (the JAX package vmaps a
per-instance ``while_loop``; a lane that is done is frozen there too).  It is
the engine every float64 NLMPC solve uses and the accuracy reference of the
float32 engines: ~15-25 iterations regardless of warm start or conditioning,
each two small Cholesky factorizations plus matrix products.

Problem form (per lane)::

    minimize    1/2 d'Bd + g'd
    subject to  Je d = be          (me equality rows)
                Ji d <= bi         (mi inequality rows, possibly padded)

``mask_i`` marks real inequality rows; padded/infinite rows are frozen out
of the barrier.  Box bounds are folded into Ji as +-identity rows by the
caller.  Returns OSQP-compatible status values so the SQP solver can treat
both inner engines uniformly (reference analog: the QP layer inside NLopt's
SLSQP, include/mpc/NLMPC/NLOptimizer.hpp:64).

Factorizations: float32 builds EXPLICIT inverses through
``batched_linalg.spd_inverse`` (the hand-written CUDA Cholesky-inverse kernel
on CUDA tensors), so every downstream solve is a matrix product; float64
keeps the library's factor-and-solve (``torch.linalg.cholesky_ex`` +
``torch.cholesky_solve``), as the JAX package does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import _host, batched_linalg
from .admm import OSQP_MAX_ITER_REACHED, OSQP_SOLVED


class PDIPSolution(NamedTuple):
    d: torch.Tensor  # (B, nz) primal
    nu: torch.Tensor  # (B, me) equality duals
    lam: torch.Tensor  # (B, mi) inequality duals (>= 0)
    gap: torch.Tensor  # (B,) final complementarity measure
    res: torch.Tensor  # (B,) final KKT residual (inf-norm)
    status: torch.Tensor  # (B,) int32
    iters: torch.Tensor  # (B,) int32


def _mv(M, v):
    """Batched matrix-vector product M v."""
    return torch.einsum("bij,bj->bi", M, v)


def _vm(v, M):
    """Batched vector-matrix product v' M."""
    return torch.einsum("bi,bij->bj", v, M)


def _amax0(v):
    """Row-wise max with 0 for an empty row."""
    if v.shape[-1] == 0:
        return torch.zeros(v.shape[:-1], dtype=v.dtype, device=v.device)
    return torch.amax(v, dim=-1)


def _chol_solver(H):
    """``r -> H^-1 r`` for a batch of SPD matrices by factor-and-solve; a
    matrix whose factorization fails yields NaN (as XLA's Cholesky does)."""
    L, info = torch.linalg.cholesky_ex(H)
    L = torch.where((info != 0)[:, None, None], float("nan"), L)

    def solve(r):
        if r.dim() == 2:
            return torch.cholesky_solve(r[..., None], L)[..., 0]
        return torch.cholesky_solve(r, L)

    return solve


def pdip_solve(B, g, Je, be, Ji, bi, mask_i, n_iters: int = 30,
               eps: float = 1e-8, eps_res: float = None, tau: float = 0.995,
               barrier_cap: float = None) -> PDIPSolution:
    """Mehrotra predictor-corrector IPM with per-lane convergence freeze.

    Shapes: B (Bt, nz, nz) PSD cost, g (Bt, nz), Je (Bt, me, nz), be
    (Bt, me), Ji (Bt, mi, nz), bi (Bt, mi), mask_i (Bt, mi) bool.  A lane
    stops iterating the moment it converges (or its Newton step degenerates)
    or after ``n_iters`` iterations; the host loop ends when every lane has
    stopped.  Regularized KKT solves: ``H = B + Ji' diag(lam/s) Ji + reg_p I``
    via Cholesky, equality block via the Schur complement
    ``Je H^-1 Je' + reg_d I``.
    """
    Bt, nz = g.shape
    me = Je.shape[1]
    mi = Ji.shape[1]
    dtype, dev = B.dtype, B.device
    kw = dict(dtype=dtype, device=dev)
    f32 = dtype == torch.float32
    if eps_res is None:
        # f32: ~30x unit roundoff — loose enough to be reachable, tight
        # enough that the returned step's constraint rows are satisfied
        # well inside the controllers' 1e-5-level feasibility tolerances
        eps_res = 3e-6 if f32 else 1e-10
    reg_p = 1e-7 if f32 else 1e-10
    reg_d = 1e-7 if f32 else 1e-10
    m_real = torch.clamp(mask_i.sum(dim=-1), min=1).to(dtype)
    big = 1e3
    eye_z = torch.eye(nz, **kw)
    eye_e = torch.eye(me, **kw)
    mask_f = mask_i.to(dtype)
    cap = (1e6 if f32 else 1e12) if barrier_cap is None else barrier_cap

    # strictly interior start: s, lam positive on real rows; frozen rows get
    # s=1, lam=0 and never enter the barrier
    d = torch.zeros((Bt, nz), **kw)
    s = torch.where(mask_i, torch.clamp(bi - _mv(Ji, d), min=1.0), 1.0)
    lam = torch.where(mask_i, 1.0, 0.0).to(dtype)
    nu = torch.zeros((Bt, me), **kw)
    done = torch.zeros((Bt,), dtype=torch.bool, device=dev)
    fail = torch.zeros((Bt,), dtype=torch.bool, device=dev)
    gap = torch.full((Bt,), float("inf"), **kw)
    res = torch.full((Bt,), float("inf"), **kw)
    it = torch.zeros((Bt,), dtype=torch.int32, device=dev)

    def kkt_res(d, nu, lam):
        r_d = _mv(B, d) + g + _vm(nu, Je) + _vm(lam * mask_f, Ji)
        r_e = _mv(Je, d) - be
        r_i = torch.where(mask_i, _mv(Ji, d) - bi, 0.0)  # <= 0 wanted
        return r_d, r_e, r_i

    def res_norm(r_d, r_e, r_i):
        return torch.maximum(
            torch.amax(torch.abs(r_d), dim=-1),
            torch.maximum(_amax0(torch.abs(r_e)), _amax0(torch.clamp(r_i, min=0.0))),
        )

    def masked_mean(v):
        return torch.sum(torch.where(mask_i, v, 0.0), dim=-1) / m_real

    def max_step(v, dv):
        """Largest alpha in (0,1] keeping v + alpha dv >= (1-tau) v."""
        ratio = torch.where((dv < 0) & mask_i, -v / torch.clamp(dv, max=-1e-30), big)
        if mi == 0:
            return torch.ones((Bt,), **kw)
        return torch.clamp(tau * torch.amin(ratio, dim=-1), max=1.0)

    while True:
        active = ~done & (it < n_iters)
        if not _host.flag(active.any()):
            break
        r_d, r_e, r_i_raw = kkt_res(d, nu, lam)
        # primal residual of the slack form: Ji d + s - bi = 0
        r_i = torch.where(mask_i, _mv(Ji, d) + s - bi, 0.0)
        mu = masked_mean(lam * s)
        res_now = res_norm(r_d, r_e, r_i_raw)
        conv = (mu < eps) & (res_now < eps_res)

        # cap the barrier diagonal: near a degenerate active constraint
        # (s -> 0 with small lam) the ratio lam/s is unbounded and the KKT
        # condition number exceeds what Cholesky survives in the working
        # precision; the cap trades late-stage quadratic convergence for a
        # bounded, factorizable system (standard IPM safeguard)
        lam_s = torch.where(
            mask_i, torch.clamp(lam / torch.clamp(s, min=1e-30), max=cap), 0.0)
        H = B + torch.einsum("bri,brj->bij", Ji * lam_s[:, :, None], Ji) + reg_p * eye_z
        if f32:
            Hinv = batched_linalg.spd_inverse(H)
            solve = lambda r, Hinv=Hinv: Hinv @ r if r.dim() == 3 else _mv(Hinv, r)
        else:
            solve = _chol_solver(H)
        # the Schur pieces depend only on the factorization, not on the
        # residuals: build them ONCE per iteration — the predictor and
        # corrector solves share them
        if me:
            HiJt = solve(Je.transpose(1, 2))  # (Bt, nz, me)
            S = Je @ HiJt + reg_d * eye_e
            if f32:
                Sinv = batched_linalg.spd_inverse(0.5 * (S + S.transpose(1, 2)))
                solveS = lambda r, Sinv=Sinv: _mv(Sinv, r)
            else:
                solveS = _chol_solver(S)

        def kkt_solve(rd, re, rcomp):
            """Solve the reduced Newton system for given residuals.

            rcomp is the complementarity target residual: lam*s - target,
            eliminated as  ds = -(rcomp + s*dlam)/lam  ->
            dlam = (lam*(-r_i) - rcomp + lam*Ji dd) / s  (standard).
            """
            rhs_d = -rd - _vm((lam * r_i - rcomp) / torch.clamp(s, min=1e-30) * mask_f, Ji)
            if me:
                Hir = solve(rhs_d)
                dnu = solveS(_mv(Je, Hir) + re)
                dd = Hir - _mv(HiJt, dnu)
            else:
                dnu = torch.zeros((Bt, 0), **kw)
                dd = solve(rhs_d)
            dlam = torch.where(
                mask_i,
                (lam * (_mv(Ji, dd) + r_i) - rcomp) / torch.clamp(s, min=1e-30),
                0.0,
            )
            ds = torch.where(
                mask_i, -(rcomp + s * dlam) / torch.clamp(lam, min=1e-30), 0.0)
            return dd, dnu, dlam, ds

        # -- affine (predictor) step ------------------------------------
        rcomp_aff = torch.where(mask_i, lam * s, 0.0)
        dd_a, dnu_a, dlam_a, ds_a = kkt_solve(r_d, r_e, rcomp_aff)
        a_aff = torch.minimum(max_step(lam, dlam_a), max_step(s, ds_a))[:, None]
        mu_aff = masked_mean((lam + a_aff * dlam_a) * (s + a_aff * ds_a))
        sigma = torch.clamp((mu_aff / torch.clamp(mu, min=1e-30)) ** 3, 0.0, 1.0)

        # -- corrector step (same factorization) ------------------------
        rcomp = torch.where(
            mask_i, lam * s + dlam_a * ds_a - (sigma * mu)[:, None], 0.0)
        dd, dnu, dlam, ds = kkt_solve(r_d, r_e, rcomp)
        alpha = torch.minimum(max_step(lam, dlam), max_step(s, ds))

        # freeze a lane whose Newton step degenerated to non-finite values
        # (extreme KKT conditioning): keep the last finite iterate rather
        # than poisoning it with NaNs
        finite = lambda v: torch.all(torch.isfinite(v), dim=-1)
        step_ok = (finite(dd) & finite(dnu) & finite(dlam) & finite(ds)
                   & torch.isfinite(alpha))
        fail = torch.where(active, fail | (~conv & ~step_ok), fail)
        # record the measured optimality metrics the moment a lane freezes
        # (they are computed from the pre-step, finite iterate)
        gap = torch.where(active, mu, gap)
        res = torch.where(active, res_now, res)
        it = it + active.to(torch.int32)
        done = done | (active & (conv | ~step_ok))
        upd = (active & ~done)[:, None]
        a = alpha[:, None]
        d = torch.where(upd, d + a * dd, d)
        nu = torch.where(upd, nu + a * dnu, nu)
        lam = torch.where(upd, lam + a * dlam, lam)
        s = torch.where(upd, s + a * ds, s)

    # final residual refresh for lanes that ran to the end
    r_d, r_e, r_i = kkt_res(d, nu, lam)
    gap = torch.where(done, gap, masked_mean(lam * s))
    res = torch.where(done, res, res_norm(r_d, r_e, r_i))
    ok = (done & ~fail) | ((gap < 1e3 * eps) & (res < 1e2 * eps_res))
    status = torch.where(ok, OSQP_SOLVED, OSQP_MAX_ITER_REACHED).to(torch.int32)
    return PDIPSolution(d=d, nu=nu, lam=lam, gap=gap, res=res, status=status, iters=it)
