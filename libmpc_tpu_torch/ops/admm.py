"""Batched OSQP-equivalent ADMM solver for box-constrained QPs.

Port of ``libmpc_tpu/ops/admm.py``.  Solves, for a *batch* of problem
instances sharing one structure::

    minimize    1/2 z'Pz + q'z
    subject to  l <= Az <= u

with the algorithm of the OSQP v0.6.3 solver the reference drives each
control step (reference: include/mpc/LMPC/LOptimizer.hpp:261-284): ADMM with
rho-scaling, over-relaxation alpha, Ruiz equilibration, adaptive rho,
primal/dual infeasibility certificates and an active-set polish.

* ``P`` (n,n) and ``A`` (m,n) are shared across the batch; only
  ``q``/``l``/``u`` carry a leading batch axis.  The KKT matrix
  ``M = P + sigma*I + A' R A`` is factorized once and explicitly inverted,
  so every ADMM iteration is three dense matrix products.
* All instances iterate in lockstep with per-instance convergence masks
  (frozen once done); termination is checked every ``check_termination``
  iterations.  Each block of iterations between checks runs through
  :func:`ops.admm_fused.fused_iterations` (the hand-written CUDA kernel on
  CUDA tensors).
* Control flow runs on the host: the loop reads its exit flags back once
  per termination check, and the adaptive-rho refactorization and the
  cold-rho branch are Python ``if``s on scalars read from the device.

:func:`admm_solve_each` solves a batch whose instances each have their own
(P, A) — the SQP's inner ``"admm"`` engine, the JAX package's ``vmap`` of
``admm_solve`` — with each lane's own scaling, rho and KKT inverse (the
batched inverse kernel of ``ops/batched_linalg.py``), lanes stopping on
their own.

Status codes reuse OSQP's integer values so ``Result.solver_status`` is
directly comparable with the reference's
(reference: include/mpc/LMPC/LOptimizer.hpp:386-415).

:func:`admm_solve` also runs the JAX package's row-sharded and
batch-sharded layouts (``axis_rows``/``axis_batch``, axes of a
``parallel.mesh.Mesh``) for ``parallel/qp_sharded.py::solve_sharded``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from ..types import LParameters
from . import _host, admm_fused, batched_linalg
from .admm_fused import mm as _mm

# -- OSQP status values (osqp/include/constants.h of OSQP v0.6.3) -----------
OSQP_SOLVED = 1
OSQP_SOLVED_INACCURATE = 2
OSQP_PRIMAL_INFEASIBLE_INACCURATE = 3
OSQP_DUAL_INFEASIBLE_INACCURATE = 4
OSQP_MAX_ITER_REACHED = -2
OSQP_PRIMAL_INFEASIBLE = -3
OSQP_DUAL_INFEASIBLE = -4
OSQP_SIGINT = -5
OSQP_TIME_LIMIT_REACHED = -6
OSQP_NON_CVX = -7
OSQP_UNSOLVED = -10

# "no budget" sentinel for the iteration budget (time_limit support)
NO_BUDGET = 2**31 - 1

RHO_MIN = 1e-6
RHO_MAX = 1e6
RHO_EQ_OVER_RHO_INEQ = 1e3
ADAPTIVE_RHO_TOLERANCE = 5.0
INF_BOUND = 1e30  # OSQP's OSQP_INFTY cut-off for "infinite" bounds
# relaxation factor of the final approximate termination check: a
# max-iteration exit re-tests the last iterate with every tolerance
# multiplied by this and reports the *_INACCURATE statuses when only the
# relaxed test passes (reference: include/mpc/LMPC/LOptimizer.hpp:398-403)
INACCURATE_TOL_FACTOR = 100.0


def full_precision(device) -> None:
    """Keep float32 matrix products in full float32 on CUDA.

    TF32 keeps about three decimal digits, and the solver converges to 1e-4
    residuals (the hazard ``libmpc_tpu/ops/admm.py:1171-1173`` guards
    against on the TPU).  Called where a solve or its setup starts."""
    if torch.device(device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")


class QPSolution(NamedTuple):
    """Solver output; every tensor has a leading batch axis."""

    x: torch.Tensor  # (B, n) primal
    y: torch.Tensor  # (B, m) dual
    z: torch.Tensor  # (B, m) constraint activity A x (projected)
    status: torch.Tensor  # (B,) int32, OSQP status values
    iters: torch.Tensor  # (B,) int32, iterations until this instance froze
    obj_val: torch.Tensor  # (B,)
    pri_res: torch.Tensor  # (B,) unscaled primal residual (inf-norm)
    dua_res: torch.Tensor  # (B,) unscaled dual residual (inf-norm)


def _inf_norm(v, dim=-1):
    return torch.amax(torch.abs(v), dim=dim)


# -- distribution helpers ----------------------------------------------------
# The solver is written once and runs in three layouts
# (libmpc_tpu/ops/admm.py:89-115): one process (axis_rows = axis_batch =
# None); the constraint rows of A/l/u/z/y split over the ranks of a mesh axis
# (axis_rows: a rank holds its row block, x-space quantities replicate,
# cross-space products sum over the axis and row-space norms take its
# maximum); and the batch split over a data axis (axis_batch: only the
# batch-global statistics, the Ruiz cost reference, the adaptive-rho
# estimate and the loop exit, reduce over it).  An axis is a
# ``parallel.mesh.Axis``.


def _over(axis, how: str, *ts):
    """``ts`` (one dtype) summed (``how`` "sum") or maximised ("max") over
    ``axis`` in one collective: a SUM of stacked tensors is elementwise and a
    MAX exact, so the values are those of one collective each.  Unchanged
    without an axis.  Returns a tuple."""
    if axis is None:
        return ts
    flat = getattr(axis, how)(torch.cat([t.reshape(-1) for t in ts]))
    out, i = [], 0
    for t in ts:
        out.append(flat[i:i + t.numel()].view(t.shape))
        i += t.numel()
    return tuple(out)


def _psum_rows(v, axis_rows):
    return _over(axis_rows, "sum", v)[0]


def _ruiz_equilibration(P, A, q_ref, iters: int, axis_rows=None):
    """Modified Ruiz equilibration of the KKT-stacked matrix (OSQP scaling.c).

    Returns diagonal scalings ``d`` (n,), ``e`` (m,) and cost scaling ``c``
    such that the scaled problem is ``(c d P d, c d q, e A d, e l, e u)``.
    ``q_ref`` is a representative linear term (batch max-abs) used only for
    the cost scaling; it does not affect the fixed point being computed.

    ``P`` (..., n, n), ``A`` (..., m, n) and ``q_ref`` (..., n) may carry
    leading batch axes: each instance is then equilibrated on its own (the
    fused inner-QP solver's per-instance problems), and ``d``, ``e``, ``c``
    carry the same axes.  Under ``axis_rows`` the A column norms take the
    maximum over the row shards.
    """
    kw = dict(dtype=P.dtype, device=P.device)
    lead = P.shape[:-2]
    d = torch.ones(lead + (P.shape[-1],), **kw)
    e = torch.ones(lead + (A.shape[-2],), **kw)
    c = torch.ones(lead, **kw)
    q = q_ref

    def limit(norm):
        # OSQP scaling.c limit_scaling: degenerate (near-zero) norms scale by
        # 1.0 — essential for structurally-zero rows, which would otherwise
        # blow the scaling up by 1e6 per Ruiz sweep
        return torch.where(norm < 1e-4, 1.0, torch.clamp(norm, max=1e4))

    for _ in range(iters):
        # column inf-norms of the stacked [[P, A'], [A, 0]]
        col_norm_x = torch.maximum(_inf_norm(P, dim=-2),
                                   _over(axis_rows, "max", _inf_norm(A, dim=-2))[0])
        col_norm_y = _inf_norm(A, dim=-1)
        dd = 1.0 / torch.sqrt(limit(col_norm_x))
        ee = 1.0 / torch.sqrt(limit(col_norm_y))
        P = P * dd[..., None, :] * dd[..., :, None]
        A = A * ee[..., :, None] * dd[..., None, :]
        q = q * dd
        # cost normalization (OSQP: gamma = 1/max(mean colnorm P, ||q||inf))
        mean_col_p = torch.mean(_inf_norm(P, dim=-2), dim=-1)
        gamma = 1.0 / limit(torch.maximum(mean_col_p, _inf_norm(q)))
        P = P * gamma[..., None, None]
        q = q * gamma[..., None]
        d, e, c = d * dd, e * ee, c * gamma
    return d, e, c


class PreparedQP(NamedTuple):
    """Time-invariant solver state hoisted out of the per-step solve
    (OSQP's setup-once semantics; ``libmpc_tpu/ops/admm.py:166``).  Shapes
    of a shared (P, A); one setup a lane adds a leading batch axis."""

    Ps: torch.Tensor  # (n, n) scaled quadratic cost
    As: torch.Tensor  # (m, n) scaled constraints
    d: torch.Tensor  # (n,) primal scaling
    e: torch.Tensor  # (m,) dual scaling
    c: torch.Tensor  # () cost scaling
    eq_mask: torch.Tensor  # (m,) structural equality rows
    loose_mask: torch.Tensor  # (m,) rows loose in every instance
    M0: torch.Tensor  # (n, n) KKT matrix at the initial rho
    Minv0: torch.Tensor  # (n, n) its explicit inverse
    # (n, n) shared polish base inverse (P + delta I + delta^-1 Aeq'Aeq)^-1
    # on the UNSCALED problem and its double-single low word; None when the
    # prepare-time params do not use the shared polish
    Mpinv: Optional[torch.Tensor]
    Mpinv_lo: Optional[torch.Tensor]


def _rho_bounds(dtype, params):
    """float32 numerics: the reference's default rho/sigma (fine for OSQP's
    pivoted f64 LDL) make M nearly singular in single precision; floor them
    and refine the x-update instead."""
    f32 = dtype == torch.float32
    sigma_v = max(params.sigma, 1e-5) if f32 else params.sigma
    rho_lo = 1e-3 if f32 else RHO_MIN
    rho_hi = 1e3 if f32 else RHO_MAX
    return sigma_v, rho_lo, rho_hi


def _rho_vec_of(rho, eq_mask, loose_mask):
    rv = torch.where(eq_mask, RHO_EQ_OVER_RHO_INEQ * rho, rho)
    return torch.where(loose_mask, RHO_MIN, rv)


def _scalar(v, like):
    # a fill, not a copy from the host: a copy would wait for the stream
    return torch.full((), v, dtype=like.dtype, device=like.device)


def prepare_qp(P, A, q_ref, eq_mask, loose_mask,
               params: LParameters, axis_rows=None) -> PreparedQP:
    """One-time setup: Ruiz equilibration + initial KKT inverse.

    ``q_ref`` is a representative linear term used only for the cost
    scaling (OSQP computes it from the q present at ``osqp_setup`` and keeps
    it when q is later updated — the same stale-c semantics apply here).

    ``P`` (..., n, n), ``A`` (..., m, n), ``q_ref`` (..., n) and the masks
    (..., m) may carry a leading batch axis: each instance is then set up on
    its own (:func:`admm_solve_each`), and every field carries the axis.
    Under ``axis_rows`` ``A``, ``e`` and the masks are the rank's row block,
    and the shared-polish pair is not built (the row-sharded solve polishes
    densely).
    """
    full_precision(P.device)
    lead, n, m = P.shape[:-2], P.shape[-1], A.shape[-2]
    kw = dict(dtype=P.dtype, device=P.device)
    if params.scaling_iters > 0:
        d, e, c = _ruiz_equilibration(P, A, q_ref, params.scaling_iters, axis_rows)
    else:
        d, e, c = torch.ones(lead + (n,), **kw), torch.ones(lead + (m,), **kw), torch.ones(lead, **kw)
    Ps = c[..., None, None] * (P * d[..., None, :] * d[..., :, None])
    As = A * e[..., :, None] * d[..., None, :]
    sigma_v, rho_lo, rho_hi = _rho_bounds(P.dtype, params)
    rho_init = torch.clamp(_scalar(params.rho, P), rho_lo, rho_hi)
    M0, Minv0 = _build_kkt_inverse(
        Ps, As, _rho_vec_of(rho_init, eq_mask, loose_mask), sigma_v, axis_rows
    )
    # the shared-polish base inverse is only built when these params will
    # run that polish; admm_solve builds it on the fly otherwise
    if params.polish and params.polish_mode == "shared" and axis_rows is None:
        Mpinv, Mpinv_lo = _polish_prep(P, A, eq_mask)
    else:
        Mpinv = Mpinv_lo = None
    return PreparedQP(
        Ps=Ps, As=As, d=d, e=e, c=c, eq_mask=eq_mask, loose_mask=loose_mask,
        M0=M0, Minv0=Minv0, Mpinv=Mpinv, Mpinv_lo=Mpinv_lo,
    )


def _scale_data(prep: PreparedQP, q, l, u):
    """The scaled (qs, ls, us) of a batch (B, n) / (B, m) under ``prep``'s
    scalings, shared or one a lane; infinite bounds stay infinite."""
    qs = prep.c[..., None] * (q * prep.d)
    ls = torch.where(l <= -INF_BOUND, l, l * prep.e)
    us = torch.where(u >= INF_BOUND, u, u * prep.e)
    return qs, ls, us


def _polish_prep(P, A, eq_mask):
    """Shared-polish base inverse pair (hi, lo) on the UNSCALED problem
    (the polish operates unscaled): equality rows are active in every
    instance.  ``P`` (n, n), ``A`` (m, n) and ``eq_mask`` (m,), or each with
    a leading batch axis for one pair a lane (:func:`admm_solve_each`; the
    JAX package's vmap of the same setup).

    Float32: the pair is the float64 inverse of ``Mp`` split into its
    float32 head and tail.  The JAX package builds it from float32 pieces
    (Jacobi-scaled Cholesky, two Newton passes, a compensated residual)
    because the TPU has no fast float64; that pair keeps a ~3e-4 relative
    error (kappa(Mp) ~ 7e4 on the quadrotor), which leaves the refinement's
    contraction near 1, so whether the polish is accepted turns on the
    rounding of the setup.  Measured on the H100: the float32 quadrotor
    golden solve's polish was rejected with the float32-built pair (command
    error 5.1e-4) and accepted with this one (1.9e-6 dual residual).  The
    setup runs once per configuration.
    """
    n = P.shape[-1]
    dtype = P.dtype
    delta = _polish_delta_shared(dtype)
    if dtype == torch.float32:
        P64, A64 = P.double(), A.double()
        w64 = eq_mask.double() / delta
        Mp64 = (P64 + delta * torch.eye(n, dtype=torch.float64, device=P.device)
                + (A64.mT * w64[..., None, :]) @ A64)
        inv = torch.cholesky_inverse(_host.cholesky(Mp64))
        hi = inv.float()
        return hi, (inv - hi.double()).float()
    eye = torch.eye(n, dtype=dtype, device=P.device)
    w_eq = eq_mask.to(dtype) / delta
    Mp = P + delta * eye + (A.mT * w_eq[..., None, :]) @ A
    # kappa(Mp) ~ 1/delta^2 overwhelms a raw float32 Cholesky; the spread
    # is diagonal-structural, so Jacobi scaling tames it, and two Newton
    # passes X <- X(2I - Ms X) square the factorization residual down to
    # the float32 floor
    s = torch.rsqrt(torch.clamp(torch.diagonal(Mp, dim1=-2, dim2=-1), min=1e-30))
    Ms = Mp * s[..., :, None] * s[..., None, :]
    Msinv = torch.cholesky_inverse(_host.cholesky(Ms))
    for _ in range(2):
        Msinv = Msinv @ (2.0 * eye - Ms @ Msinv)
    Mpinv = Msinv * s[..., :, None] * s[..., None, :]
    # double-single low word: E = I - Mp Mpinv via a compensated product,
    # then lo = Mpinv E; applying (Mpinv + Mpinv_lo) removes the eps.kappa
    # systematic error of the stored float32 inverse
    e_hi, e_lo = _comp_mm(Mp, Mpinv)
    E = (eye - e_hi) - e_lo
    Mpinv_lo = Mpinv @ E
    return Mpinv, Mpinv_lo


def _build_kkt_inverse(P, A, rho_vec, sigma, axis_rows=None):
    """Explicit inverse (and the matrix itself) of
    M = P + sigma*I + A' diag(rho) A.

    An explicit inverse turns every ADMM x-update into a plain matrix
    product.  M is returned too so float32 runs can refine the x-update
    against it.  Shared (P, A): one (n, n) Cholesky, a library
    factorization, not a kernel of this port.  One matrix a lane (``P``
    (B, n, n), ``A`` (B, m, n), ``rho_vec`` (B, m)): the batched inverse
    kernel K2 (:func:`ops.batched_linalg.chol_inverse`; its twin on CPU
    tensors), and past its gate, n > 64, the blocked Schur recursion over
    it on either device (``libmpc_tpu/ops/batched_linalg.py:158-175``).
    With row-sharded A (``axis_rows``) the shards' A' R A sum into the
    replicated M.
    """
    eye = torch.eye(P.shape[-1], dtype=P.dtype, device=P.device)
    AtRA = _psum_rows((A.mT * rho_vec[..., None, :]) @ A, axis_rows)
    M = P + sigma * eye + AtRA
    if M.dim() == 2:
        return M, batched_linalg.spd_inverse(M).contiguous()
    if batched_linalg.kernel_supported(M.shape[-1]):
        return M, batched_linalg.chol_inverse(M)
    return M, batched_linalg.chol_inverse_blocked(M).contiguous()


class _LoopState(NamedTuple):
    x: torch.Tensor
    z: torch.Tensor
    y: torch.Tensor
    x_prev: torch.Tensor  # snapshot at last check (for dual-infeas cert)
    y_prev: torch.Tensor
    iters: torch.Tensor
    done: torch.Tensor
    status: torch.Tensor
    pri_res: torch.Tensor
    dua_res: torch.Tensor
    # status a max-iter exit would report: OSQP's final
    # check_termination(approximate) with 100x-relaxed tolerances,
    # refreshed at every periodic check for still-active instances
    inacc_status: torch.Tensor
    pri_chk: torch.Tensor  # (B,) residuals at the previous check — stall
    dua_chk: torch.Tensor  # detection state (params.stall_checks)
    stall_ct: torch.Tensor  # (B,) consecutive no-improvement checks
    rho: torch.Tensor  # () shared across the batch, or (B,) one a lane
    M: torch.Tensor  # (n, n), or (B, n, n) one a lane
    Minv: torch.Tensor


# per-lane fields of _LoopState (gathered by straggler compaction)
_LANE_FIELDS = ("x", "z", "y", "x_prev", "y_prev", "iters", "done", "status",
                "pri_res", "dua_res", "inacc_status", "pri_chk", "dua_chk",
                "stall_ct")


def _termination_check(state: _LoopState, P, A, qs, ls, us, d, e, c,
                       params: LParameters, axis_rows=None, axis_batch=None):
    """OSQP's periodic check on the unscaled residuals: convergence,
    infeasibility certificates, the relaxed verdict a max-iteration exit
    would report, float32 stall detection and the adaptive-rho estimate.

    Shared (P, A): ``P`` (n, n), ``A`` (m, n), scalings ``d`` (n,), ``e``
    (m,), ``c`` () and one rho (0-d) for the batch.  Per lane
    (:func:`admm_solve_each`): ``P`` (B, n, n), ``A`` (B, m, n), ``d``
    (B, n), ``e`` (B, m), ``c`` (B,) and rho (B,); each lane's adaptive-rho
    estimate is then the geometric mean over that lane alone.

    Sharded (shared (P, A) only): under ``axis_rows`` ``A``, ``e``, z/y and
    the bounds are the rank's row block; the cross-space products and the
    support function sum over the row shards in one collective, and the
    row norms and the recession-cone test take their maximum in another.
    Under ``axis_batch`` the adaptive-rho estimate's log-sum and count sum
    over the batch shards.

    Returns the updated state, the adaptive-rho verdict and the rho
    estimate (0-d tensors, or (B,) per lane; still on the device).
    """
    f32 = P.dtype == torch.float32
    _, rho_lo, rho_hi = _rho_bounds(P.dtype, params)
    cc = c if c.dim() == 0 else c[:, None]  # c against (B, m) rows
    x, z, y = state.x, state.z, state.y
    # -- unscaled residuals ------------------------------------------
    Ax = _mm(x, A.mT)
    Px = _mm(x, P)
    Aty = _mm(y, A)
    pri = _inf_norm((Ax - z) / e)
    pri_rel = torch.maximum(_inf_norm(Ax / e), _inf_norm(z / e))

    # -- infeasibility certificates (unscaled deltas) ----------------
    # unscaling: x = D x_bar, y = c^-1 E y_bar
    dy = (y - state.y_prev) * e / cc
    dx = (x - state.x_prev) * d
    norm_dy = _inf_norm(dy)
    norm_dx = _inf_norm(dx)

    # primal infeasibility: ||A' dy|| small and support function negative
    Atdy_v = _mm(y - state.y_prev, A)
    u_unscaled = us / e
    l_unscaled = ls / e
    dy_plus = torch.clamp(dy, min=0.0)
    dy_minus = torch.clamp(dy, max=0.0)
    # the where() keeps 0 * (+-1e30) bounds out of the sum on rows
    # whose dual did not move that way
    sup = torch.sum(
        torch.where(dy_plus > 0, torch.clamp(u_unscaled, max=INF_BOUND) * dy_plus, 0.0)
        + torch.where(dy_minus < 0, torch.clamp(l_unscaled, min=-INF_BOUND) * dy_minus, 0.0),
        dim=-1,
    )

    # dual infeasibility: P dx ~ 0, q'dx < 0, A dx in recession cone
    Pdx = _inf_norm(_mm(dx / d, P) / d) / c
    qdx = torch.sum(qs / d * dx, dim=-1) / c
    Adx = _mm(dx / d, A.mT) / e
    u_inf = u_unscaled >= INF_BOUND
    l_inf = l_unscaled <= -INF_BOUND

    def cone_recession(eps_d):
        ed = eps_d[:, None]
        inside = torch.where(
            u_inf, Adx >= -ed,
            torch.where(l_inf, Adx <= ed, torch.abs(Adx) <= ed),
        )
        return torch.all((u_inf & l_inf) | inside, dim=-1)

    # the test at the certificate's tolerance and at the relaxed one
    eps_d = params.eps_dual_inf * norm_dx
    eps_d_i = INACCURATE_TOL_FACTOR * params.eps_dual_inf * norm_dx
    cone, cone_i = cone_recession(eps_d), cone_recession(eps_d_i)
    if axis_rows is not None:
        Aty, Atdy_v, sup = _over(axis_rows, "sum", Aty, Atdy_v, sup)
        pri, pri_rel, norm_dy, out, out_i = _over(
            axis_rows, "max", pri, pri_rel, norm_dy, (~cone).to(x.dtype), (~cone_i).to(x.dtype))
        cone, cone_i = out == 0, out_i == 0

    dua = _inf_norm((Px + qs + Aty) / d) / c
    dua_rel = torch.maximum(
        torch.maximum(_inf_norm(Px / d), _inf_norm(Aty / d)),
        _inf_norm(qs / d),
    ) / c
    eps_pri = params.eps_abs + params.eps_rel * pri_rel
    eps_dua = params.eps_abs + params.eps_rel * dua_rel
    solved = (pri <= eps_pri) & (dua <= eps_dua)

    Atdy = _inf_norm(Atdy_v / d) / c
    # OSQP auxil.c is_primal_infeasible: ||dy|| > eps, support function
    # strictly negative, and A'dy ~ 0
    eps_p = params.eps_prim_inf * norm_dy
    prim_inf = (norm_dy > params.eps_prim_inf) & (sup < -eps_p) & (Atdy < eps_p)

    def is_dual_infeasible(eps_dual_inf, eps_d, cone):
        # OSQP auxil.c is_dual_infeasible: ||dx|| > eps, q'dx strictly
        # negative, P dx ~ 0, and A dx in the recession cone
        return ((norm_dx > eps_dual_inf) & (Pdx < eps_d) & (qdx < -eps_d) & cone)

    dual_inf = is_dual_infeasible(params.eps_dual_inf, eps_d, cone)

    # -- relaxed re-check: the status a max-iteration exit reports -----
    # OSQP's osqp_solve re-runs check_termination(approximate) on the
    # final iterate with every tolerance relaxed 100x and reports the
    # *_INACCURATE statuses when only the relaxed test passes; refreshing
    # the verdict at every check for still-active instances makes the
    # value at loop exit the final-iterate verdict
    fac = INACCURATE_TOL_FACTOR
    solved_inacc = (pri <= fac * eps_pri) & (dua <= fac * eps_dua)
    eps_p_i = fac * params.eps_prim_inf * norm_dy
    prim_inf_inacc = (
        (norm_dy > fac * params.eps_prim_inf)
        & (sup < -eps_p_i)
        & (Atdy < eps_p_i)
    )
    dual_inf_inacc = is_dual_infeasible(fac * params.eps_dual_inf, eps_d_i, cone_i)
    inacc = torch.where(
        solved_inacc, OSQP_SOLVED_INACCURATE,
        torch.where(
            prim_inf_inacc, OSQP_PRIMAL_INFEASIBLE_INACCURATE,
            torch.where(dual_inf_inacc, OSQP_DUAL_INFEASIBLE_INACCURATE,
                        state.inacc_status.new_full((), OSQP_MAX_ITER_REACHED)),
        ),
    )

    newly = ~state.done
    # -- straggler stall detection (float32 only) ----------------------
    # an instance whose residuals improved by <1% for `stall_checks`
    # consecutive checks, inside a 10x band of the tolerance, freezes
    # with the verdict a max-iteration exit would give it
    if params.stall_checks > 0 and f32:
        improved = (pri <= 0.99 * state.pri_chk) | (dua <= 0.99 * state.dua_chk)
        stall_ct = torch.where(
            newly, torch.where(improved, 0, state.stall_ct + 1), state.stall_ct
        )
        solved_near = (pri <= 10.0 * eps_pri) & (dua <= 10.0 * eps_dua)
        stalled = (newly & ~(solved | prim_inf | dual_inf)
                   & (stall_ct >= params.stall_checks) & solved_near)
    else:
        stall_ct = state.stall_ct
        stalled = torch.zeros_like(newly)

    status = torch.where(
        newly & solved, OSQP_SOLVED,
        torch.where(
            newly & prim_inf, OSQP_PRIMAL_INFEASIBLE,
            torch.where(
                newly & dual_inf, OSQP_DUAL_INFEASIBLE,
                torch.where(stalled, OSQP_SOLVED_INACCURATE, state.status),
            ),
        ),
    )
    done = state.done | solved | prim_inf | dual_inf | stalled

    # -- adaptive rho (shared across the batch to keep one shared factor,
    # or each lane's own) -------------------------------------------
    if params.adaptive_rho:
        ratio = torch.sqrt(torch.clamp(
            (pri / torch.clamp(pri_rel, min=1e-12))
            / torch.clamp(dua / torch.clamp(dua_rel, min=1e-12), min=1e-12),
            1e-10, 1e10,
        ))
        ratio = torch.nan_to_num(ratio, nan=1.0, posinf=1e10, neginf=1e-10)
        # geometric mean over still-active instances: the batch's, or a
        # lane's over itself (n_act 0 or 1; the exp(log) round trip is the
        # JAX package's, whose rounding the tolerance test sees)
        active = ~done
        log_sum = torch.where(active, torch.log(ratio), 0.0)
        n_act = active.long()
        if state.rho.dim() == 0:
            log_sum, n_act = torch.sum(log_sum), torch.sum(n_act)
            if axis_batch is not None:
                # across the whole batch, so that every shard makes the rho
                # decision an unsharded batch would
                log_sum, n_all = _over(axis_batch, "sum", log_sum, n_act.to(log_sum.dtype))
                n_act = n_all.long()
        rho_est = state.rho * torch.exp(log_sum / torch.clamp(n_act, min=1))
        rho_est = torch.clamp(torch.nan_to_num(rho_est, nan=rho_lo), rho_lo, rho_hi)
        need_update = (n_act > 0) & (
            (rho_est > state.rho * ADAPTIVE_RHO_TOLERANCE)
            | (rho_est < state.rho / ADAPTIVE_RHO_TOLERANCE)
        )
    else:
        rho_est = state.rho
        need_update = torch.zeros_like(state.rho, dtype=torch.bool)

    state = state._replace(
        x_prev=x,
        y_prev=y,
        done=done,
        status=status,
        pri_res=torch.where(newly, pri, state.pri_res),
        dua_res=torch.where(newly, dua, state.dua_res),
        inacc_status=torch.where(newly, inacc, state.inacc_status),
        pri_chk=torch.where(newly, pri, state.pri_chk),
        dua_chk=torch.where(newly, dua, state.dua_chk),
        stall_ct=stall_ct,
    )
    return state, need_update, rho_est


def _agreed_flags(mesh, all_done, need_update, block: int):
    """A sharded loop's branch after a check, the same on every rank:
    whether every instance of the whole batch is done (the data shards'
    AND, as JAX's psum over ``axis_batch``), and whether this rank's row
    group rebuilds its KKT inverse (each data shard's own, as under JAX's
    ``lax.cond``).  One MAX over the whole mesh of each data index's flags
    beside their negations, one host read.  The ranks of a row group hold
    the same flags by construction; ranks that disagreed would take two
    branches and hang at the next collective, so a disagreement raises."""
    D, di = mesh.shape["data"], mesh.data_index
    v = torch.zeros((4, D), dtype=torch.float64, device=all_done.device)
    v[:, di] = torch.stack([all_done, ~all_done, need_update, ~need_update]).to(torch.float64)
    done, not_done, upd, not_upd = _host.values(mesh.axis(None).max(v))
    split = [i for i in range(D) if done[i] + not_done[i] != 1 or upd[i] + not_upd[i] != 1]
    if split:
        raise RuntimeError(
            f"sharded ADMM, block {block}: the ranks of data index {split} disagree "
            f"on the loop's exit or on the rho update"
        )
    return all(done), bool(upd[di])


def _admm_loop(P, A, qs, ls, us, x0, y0, rho0, rho_mask_eq, rho_mask_loose,
               d, e, c, M0, Minv0, iter_budget: int, params: LParameters,
               n_iters: int, check_every: int, axis_rows=None,
               axis_batch=None) -> _LoopState:
    """Scaled-problem ADMM iterations with periodic termination checks.

    All of P/A/q/l/u here are the *scaled* quantities; d/e/c unscale
    residuals for termination (OSQP checks unscaled residuals by default).
    ``M0``/``Minv0`` are the KKT matrix/inverse at the initial rho.

    ``iter_budget`` is an iteration cap implementing the ``time_limit``
    contract: the loop stops at the first termination check past the
    budget and unconverged instances report ``OSQP_TIME_LIMIT_REACHED``.
    Pass ``NO_BUDGET`` for no limit.

    Sharded (``axis_rows``/``axis_batch`` set): the plain iterations run,
    their x-update's ``(rho z - y) A`` summed over the row shards, as the
    JAX package runs its XLA loop there (its Pallas block needs
    ``axis_rows`` None); there is no straggler compaction, and the
    branches after each check come from :func:`_agreed_flags`.
    """
    B = qs.shape[0]
    dtype = P.dtype
    dev = P.device
    f32 = dtype == torch.float32
    sigma_v, rho_lo, rho_hi = _rho_bounds(dtype, params)
    refine = f32 and params.x_refine
    sharded = axis_rows is not None or axis_batch is not None
    if sharded:
        iterate = functools.partial(
            admm_fused.plain_iterations,
            reduce=None if axis_rows is None else axis_rows.sum)
    else:
        iterate = (admm_fused.fused_iterations if params.use_pallas
                   else admm_fused.plain_iterations)

    def rho_vec_of(rho):
        return _rho_vec_of(rho, rho_mask_eq, rho_mask_loose)

    def full(v, dt):
        return torch.full((B,), v, dtype=dt, device=dev)

    state = _LoopState(
        x=x0, z=x0 @ A.T, y=y0, x_prev=x0, y_prev=y0,
        iters=full(0, torch.int32),
        done=full(False, torch.bool),
        status=full(OSQP_UNSOLVED, torch.int32),
        pri_res=full(float("inf"), dtype),
        dua_res=full(float("inf"), dtype),
        inacc_status=full(OSQP_MAX_ITER_REACHED, torch.int32),
        pri_chk=full(float("inf"), dtype),
        dua_chk=full(float("inf"), dtype),
        stall_ct=full(0, torch.int32),
        rho=torch.clamp(rho0.to(dtype), rho_lo, rho_hi),
        M=M0, Minv=Minv0,
    )

    def block(state: _LoopState, qs, ls, us, k):
        """Block ``k``: its iterations + termination check.  Returns the new
        state, whether every lane is done and the count of active lanes
        (None when sharded; one device-to-host read per block)."""
        with _host.span("libmpc.admm.iterate"):
            x, z, y = iterate(
                state.x, state.z, state.y, state.done, qs, ls, us,
                A, state.M, state.Minv, rho_vec_of(state.rho),
                sigma=sigma_v, alpha=params.alpha, k_iters=check_every,
                refine=refine,
            )
            state = state._replace(
                x=x, z=z, y=y,
                iters=state.iters + torch.where(state.done, 0, check_every).to(torch.int32),
            )
        with _host.span("libmpc.admm.check"):
            state, need_update, rho_est = _termination_check(
                state, P, A, qs, ls, us, d, e, c, params, axis_rows, axis_batch
            )
            if sharded:
                all_done, update = _agreed_flags(
                    (axis_rows or axis_batch).mesh, state.done.all(), need_update, k)
                n_active = None
            else:
                all_done, update, n_active = _host.values(torch.stack([
                    state.done.all().long(), need_update.long(), (~state.done).sum(),
                ]))
        if update:
            with _host.span("libmpc.admm.refactor"):
                M, Minv = _build_kkt_inverse(P, A, rho_vec_of(rho_est), sigma_v, axis_rows)
                state = state._replace(rho=rho_est, M=M, Minv=Minv)
        return state, bool(all_done), n_active

    n_blocks = max(1, (n_iters + check_every - 1) // check_every)
    budget = int(iter_budget)

    def go_on(k, stop):
        return k < n_blocks and not stop and k * check_every < budget

    # -- straggler compaction ------------------------------------------
    # Lockstep batches pay for their slowest instance: when the active
    # count falls to ``cap`` (a 1/16th-ish of the batch), the unconverged
    # instances are compacted into a cap-sized batch and only that
    # continues — identical per-row math and check cadence.
    cap = 8
    while cap * 32 <= B:
        cap *= 2
    compact = params.compact_stragglers and not sharded and cap < B and B >= 256

    k, stop, n_active = 0, False, B
    while go_on(k, stop) and (not compact or n_active > cap):
        state, stop, n_active = block(state, qs, ls, us, k)
        k += 1

    if compact and go_on(k, stop):
        with _host.span("libmpc.admm.compact"):
            # unconverged lanes first; ties among done lanes are harmless
            _, idx = torch.topk((~state.done).to(torch.float32), cap)
            sub = state._replace(**{f: getattr(state, f)[idx] for f in _LANE_FIELDS})
            qs_c, ls_c, us_c = qs[idx], ls[idx], us[idx]
        while go_on(k, stop):
            sub, stop, _ = block(sub, qs_c, ls_c, us_c, k)
            k += 1
        with _host.span("libmpc.admm.compact"):
            state = sub._replace(**{
                f: getattr(state, f).index_copy(0, idx, getattr(sub, f))
                for f in _LANE_FIELDS
            })

    # instances that never converged: distinguish a budget (time-limit) stop
    # from an ordinary max-iteration exhaustion; a max-iteration exit
    # reports the relaxed-tolerance verdict of the final check
    budget_hit = k < n_blocks and k * check_every >= budget
    max_iter_status = (
        torch.full_like(state.inacc_status, OSQP_TIME_LIMIT_REACHED)
        if budget_hit else state.inacc_status
    )
    status = torch.where(state.status == OSQP_UNSOLVED, max_iter_status, state.status)
    return state._replace(status=status)


def _polish_delta(dtype) -> float:
    """Dense-polish penalty regularizer: float32 needs a larger delta (and
    more refinement) than f64."""
    return 1e-4 if dtype == torch.float32 else 1e-6


def _polish_delta_shared(dtype) -> float:
    """Shared-polish penalty regularizer (``libmpc_tpu/ops/admm.py:835``):
    1e-2 keeps the factorization of the shared base matrix comfortably
    inside float32; the ~0.7/pass refinement contraction is paid for with
    many cheap compensated-residual passes."""
    return 1e-2 if dtype == torch.float32 else 1e-4


def _split12(a):
    """Dekker split of float32 into an 8-bit-mantissa head and a tail: a
    head x head product is exact in float32."""
    c = a * 65537.0  # 2^16 + 1 -> 8-bit head, 16-bit tail
    hi = c - (c - a)
    return hi, a - hi


def _two_sum(a, b):
    """Knuth's error-free addition: s + e == a + b exactly."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def _comp_mm(X, M, chunk=32):
    """Compensated ``X @ M`` -> (hi, lo) double-single pair, float32 ops.

    The head-product partial sums are accumulated per contraction chunk and
    combined with error-free TwoSums; the cross/tail products are ~eps of
    the result and go straight into the low word.  ``M`` may be one matrix
    a lane (see :func:`_mm`).  Depends on IEEE order of the elementwise
    operations: eager PyTorch keeps it (do not compile this)."""
    Xh, Xl = _split12(X)
    Mh, Ml = _split12(M)
    K = M.shape[-2]
    hi = None
    lo = 0.0
    for c0 in range(0, K, chunk):
        p = _mm(Xh[..., c0 : c0 + chunk], Mh[..., c0 : c0 + chunk, :])
        if hi is None:
            hi = p
        else:
            hi, e = _two_sum(hi, p)
            lo = lo + e
    lo = lo + (_mm(X, Ml) + _mm(Xl, Mh))
    return hi, lo


def _polish_active_set(l, u, sol_y, eq_mask, dtype, delta):
    """Active rows from dual signs (OSQP polish.c) -> (active, b, w)."""
    low_active = (sol_y < 0) | (eq_mask & (sol_y <= 0))
    upp_active = sol_y > 0
    active = low_active | upp_active
    b = torch.where(low_active, l, torch.where(upp_active, u, 0.0))
    w = active.to(dtype) / delta  # (B, m) row weights
    return active, b, w


def _polish_accept(P, A, q, l, u, sol_x, sol_y, sol_z, x_pol, y_pol, active,
                   axis_rows=None):
    """Per-instance acceptance: keep the polished solution only if it
    reduces both residual norms (OSQP polish.c:polish()).  Under
    ``axis_rows`` the residuals' row products sum, and their row norms take
    the maximum, over the row shards."""
    y_pol = torch.where(active, y_pol, 0.0)
    z_pol = torch.clamp(_mm(x_pol, A.mT), min=l, max=u)
    Aty0, Aty1 = _over(axis_rows, "sum", _mm(sol_y, A), _mm(y_pol, A))
    pri0, pri1 = _over(axis_rows, "max", _inf_norm(_mm(sol_x, A.mT) - sol_z),
                       _inf_norm(_mm(x_pol, A.mT) - z_pol))
    dua0 = _inf_norm(_mm(sol_x, P) + q + Aty0)
    dua1 = _inf_norm(_mm(x_pol, P) + q + Aty1)
    better = (pri1 <= pri0) & (dua1 <= dua0)
    bsel = better[:, None]
    return (
        torch.where(bsel, x_pol, sol_x),
        torch.where(bsel, y_pol, sol_y),
        torch.where(bsel, z_pol, sol_z),
        torch.where(better, pri1, pri0),
        torch.where(better, dua1, dua0),
    )


def _polish_shared(P, A, q, l, u, sol_x, sol_y, sol_z, params: LParameters,
                   eq_mask, Mpinv, Mpinv_lo):
    """Active-set polish with ONE shared factorization + exact per-instance
    Woodbury corrections (``libmpc_tpu/ops/admm.py:933``).

    The per-instance active-set system is ``K_i = Mp + delta^-1 U_i U_i'``
    with the shared ``Mp = P + delta I + delta^-1 Aeq'Aeq`` and the low-rank
    ``U_i = A[active ineq rows of i]'`` (at most ``k_max`` of them)::

        K^-1 r = Mpinv r - Mpinv U (delta I + U' Mpinv U)^-1 U' Mpinv r

    The (B, k_max, k_max) capacitance matrices are inverted by
    :func:`ops.batched_linalg.chol_inverse` (the hand-written CUDA kernel on
    CUDA tensors).  Outer refinement against the TRUE optimality system
    contracts the O(delta) penalty bias each pass.  Instances with more
    than ``k_max`` active inequality rows get an inexact correction and are
    caught by the acceptance test (kept unpolished).  With one (P, A) a lane
    (:func:`admm_solve_each`) ``Mp`` and its inverse pair are each lane's
    own and the formulas are the same lane by lane.
    """
    dtype = P.dtype
    m = A.shape[-2]
    delta = _polish_delta_shared(dtype)
    outer_iters = max(6, params.polish_refine_iter)
    k_max = min(params.polish_active_cap, m)

    def mp_solve(r):
        # the double-single inverse pair: two plain products
        return _mm(r, Mpinv) + _mm(r, Mpinv_lo)

    active, bnd, w = _polish_active_set(l, u, sol_y, eq_mask, dtype, delta)

    # per-instance indices of the active inequality rows, padded with
    # inactive rows masked out of the capacitance.  Shared (P, A):
    # torch.topk, which breaks ties in another order than lax.top_k, so C
    # comes out permuted and the solve is the same up to rounding.  One
    # (P, A) a lane: lax.top_k's order, lowest index first among equals, so
    # that a lane with more than k_max active rows keeps the same k_max rows
    # as in the JAX package
    extra = active & ~eq_mask
    if A.dim() == 2:
        _, idx = torch.topk(extra.to(dtype), k_max, dim=-1)  # (B, k)
        rows = A[idx]
    else:
        idx = torch.sort(extra.to(dtype), dim=-1, descending=True,
                         stable=True).indices[:, :k_max]
        rows = torch.gather(A, 1, idx[:, :, None].expand(-1, -1, A.shape[-1]))
    valid = torch.gather(extra, -1, idx)  # (B, k)
    A_g = torch.where(valid[:, :, None], rows, 0.0)  # (B, k, n), masked rows zeroed

    # batched capacitance C = delta I + U' Mpinv U; invalid slots become
    # decoupled unit equations
    A_gM = A_g @ Mpinv  # (B, k, n)
    Ck = A_gM @ A_g.transpose(1, 2)  # (B, k, k)
    eye_k = torch.eye(k_max, dtype=dtype, device=P.device)
    C = Ck + delta * eye_k[None] + (~valid).to(dtype)[:, :, None] * eye_k[None]
    Cinv = batched_linalg.chol_inverse(C.contiguous())

    def K_solve(r):  # (B, n) -> exact K_i^-1 r
        t = mp_solve(r)
        v = (A_g @ t[:, :, None])[..., 0]  # (B, k)
        yk = (Cinv @ v[:, :, None])[..., 0]
        corr = (yk[:, None, :] @ A_g)[:, 0]  # (B, n)
        return t - mp_solve(corr)

    x = sol_x  # the ADMM iterate is already close
    nu = torch.where(active, sol_y, 0.0)

    def correct(x, nu, r1, r2):
        dx = K_solve(r1 + _mm(w * r2, A))
        dnu = w * (_mm(dx, A.mT) - r2)
        return x + dx, nu + dnu, dx, dnu

    def plain(x, nu):
        r1 = -q - _mm(x, P) - _mm(torch.where(active, nu, 0.0), A)
        r2 = torch.where(active, bnd - _mm(x, A.mT), 0.0)
        x, nu, _, _ = correct(x, nu, r1, r2)
        return x, nu

    if dtype == torch.float32:
        # float32 schedule: plain passes contract the penalty bias down to
        # the float32 matvec noise floor; ONE compensated residual
        # evaluation re-anchors the true residual to ~eps^2, and cheap
        # incremental passes continue the contraction below that floor
        for _ in range(3):
            x, nu = plain(x, nu)
        h1, l1 = _comp_mm(x, P)
        h2, l2 = _comp_mm(torch.where(active, nu, 0.0), A)
        s, e1 = _two_sum(-q, -h1)
        s, e2 = _two_sum(s, -h2)
        r1 = s + (e1 + e2 - l1 - l2)
        h3, l3 = _comp_mm(x, A.mT)
        bnd_m = torch.where(active, bnd, 0.0)
        s3, e3 = _two_sum(bnd_m, -h3)
        r2 = torch.where(active, s3 + (e3 - l3), 0.0)
        for _ in range(max(params.polish_comp_passes, 0)):
            x, nu, dx, dnu = correct(x, nu, r1, r2)
            r1 = r1 - _mm(dx, P) - _mm(dnu, A)
            r2 = torch.where(active, r2 - _mm(dx, A.mT), 0.0)
        x_pol, y_pol = x, nu
    else:
        for _ in range(outer_iters):
            x, nu = plain(x, nu)
        x_pol, y_pol = x, nu
    return _polish_accept(P, A, q, l, u, sol_x, sol_y, sol_z, x_pol, y_pol, active)


def _polish(P, A, q, l, u, sol_x, sol_y, sol_z, params: LParameters, eq_mask,
            axis_rows=None):
    """Active-set polish (OSQP polish.c, penalty/Schur-complement form) with
    per-instance dense factorizations (``libmpc_tpu/ops/admm.py:1067``).

    Solves the stabilized equality-constrained QP of each instance::

        (P + delta I + A_act' (1/delta) A_act) x = -q + A_act' b / delta

    with a fixed (n, n) shape (active sets enter as per-instance 0/1 row
    weights), then refines against the unregularized KKT system.  An
    instance whose matrix the Cholesky factorization refuses gets NaN, as
    under JAX's ``cho_factor``, and the acceptance test keeps its ADMM
    iterate.  Under ``axis_rows`` (the row-sharded solve) the row products
    sum over the row shards: the matrices once, then one collective a
    refinement pass.
    """
    dtype = P.dtype
    n = P.shape[-1]
    f32 = dtype == torch.float32
    delta = _polish_delta(dtype)
    refine_iters = (max(params.polish_refine_iter, 15) if f32
                    else params.polish_refine_iter)

    active, b, w = _polish_active_set(l, u, sol_y, eq_mask, dtype, delta)
    eye = torch.eye(n, dtype=dtype, device=P.device)
    AtWA = _psum_rows(A.mT @ (w[:, :, None] * A), axis_rows)
    M = P + delta * eye + AtWA  # (B, n, n)
    L, info = torch.linalg.cholesky_ex(M)
    L = torch.where((info != 0)[:, None, None], float("nan"), L)

    def cho_solve(r):
        return torch.cholesky_solve(r[:, :, None], L)[..., 0]

    x = cho_solve(-q + _psum_rows(_mm(w * b, A), axis_rows))
    nu = w * (_mm(x, A.mT) - b)
    for _ in range(refine_iters):
        r2 = torch.where(active, b - _mm(x, A.mT), 0.0)
        Anu, Awr = _over(axis_rows, "sum", _mm(torch.where(active, nu, 0.0), A),
                         _mm(w * r2, A))
        r1 = -q - _mm(x, P) - Anu
        dx = cho_solve(r1 + Awr)
        dnu = w * (_mm(dx, A.mT) - r2)
        x, nu = x + dx, nu + dnu
    return _polish_accept(P, A, q, l, u, sol_x, sol_y, sol_z, x, nu, active, axis_rows)


def _finish(state: _LoopState, prep: PreparedQP, P, A, q, l, u,
            params: LParameters, axis_rows=None) -> QPSolution:
    """The loop's end, for either solver: unscale the state, take the
    polish where the lane solved, and the objective.  ``P``/``A`` are the
    unscaled matrices, shared or one a lane as in ``prep``.  Under
    ``axis_rows`` the polish is the dense one whatever ``polish_mode`` says
    (the shared polish gathers rows across the shards;
    ``libmpc_tpu/ops/admm.py:1330-1345``)."""
    d, e, c = prep.d, prep.e, prep.c
    x = state.x * d
    y = state.y * e / c[..., None]
    z = state.z / e
    pri_res, dua_res = state.pri_res, state.dua_res

    if params.polish:
        with _host.span("libmpc.admm.polish"):
            if params.polish_mode == "shared" and axis_rows is None:
                # a prepared cache built under no-polish params has no pair
                pair = ((prep.Mpinv, prep.Mpinv_lo) if prep.Mpinv is not None
                        else _polish_prep(P, A, prep.eq_mask))
                x_p, y_p, z_p, pri_p, dua_p = _polish_shared(
                    P, A, q, l, u, x, y, z, params, prep.eq_mask, *pair
                )
            else:
                x_p, y_p, z_p, pri_p, dua_p = _polish(
                    P, A, q, l, u, x, y, z, params, prep.eq_mask, axis_rows
                )
            ok = (state.status == OSQP_SOLVED) | (state.status == OSQP_SOLVED_INACCURATE)
            sel = ok[:, None]
            x = torch.where(sel, x_p, x)
            y = torch.where(sel, y_p, y)
            z = torch.where(sel, z_p, z)
            pri_res = torch.where(ok, pri_p, pri_res)
            dua_res = torch.where(ok, dua_p, dua_res)

    obj = 0.5 * torch.sum(_mm(x, P) * x, dim=-1) + torch.sum(q * x, dim=-1)
    return QPSolution(
        x=x, y=y, z=z, status=state.status, iters=state.iters, obj_val=obj,
        pri_res=pri_res, dua_res=dua_res,
    )


def admm_solve(
    P: torch.Tensor,
    A: torch.Tensor,
    q: torch.Tensor,
    l: torch.Tensor,
    u: torch.Tensor,
    params: LParameters = LParameters(),
    warm_x: Optional[torch.Tensor] = None,
    warm_y: Optional[torch.Tensor] = None,
    eq_mask: Optional[torch.Tensor] = None,
    iter_budget: Optional[int] = None,
    prepared: Optional[PreparedQP] = None,
    have_warm=None,
    axis_rows=None,
    axis_batch=None,
) -> QPSolution:
    """Solve a batch of QPs sharing (P, A) structure.

    ``axis_rows``/``axis_batch`` are axes of a ``parallel.mesh.Mesh``
    (``mesh.axis("model")``, ``mesh.axis("data")``), given on every rank
    of the mesh.  With ``axis_rows`` the constraint rows of A/l/u (and
    z/y) are this rank's block of a row-sharded problem: cross-space
    products sum over the axis and row norms take its maximum, through Ruiz
    scaling, the KKT inverse, every iteration's x-update, the checks with
    both certificates, the KKT seed and the dense polish that replaces the
    shared one.  With ``axis_batch`` the batch is this rank's shard, and
    the batch-global statistics (the Ruiz cost reference, the adaptive-rho
    estimate, the loop exit) reduce over it.  The equality and loose masks
    and ``cold_rho``'s test for a warm lane stay the shard's own, as in the
    JAX package.  Either axis runs the plain iterations (no K1) without
    straggler compaction.  ``parallel/qp_sharded.py::solve_sharded`` is the
    entry point that lays the data out.

    Args:
      P: (n, n) quadratic cost (full symmetric, not upper-tri).
      A: (m, n) constraint matrix.
      q, l, u: (B, n) / (B, m) (or unbatched (n,) / (m,)) per-instance data.
      params: OSQP-style settings.
      warm_x, warm_y: optional warm-start primal/dual, shaped like q / l.
      eq_mask: optional (m,) bool marking structural equality rows (l == u);
        inferred (conservatively over the batch) when omitted.
      iter_budget: optional iteration cap implementing the ``time_limit``
        contract; unconverged instances stopped by it report
        ``OSQP_TIME_LIMIT_REACHED``.  ``None`` means unlimited.
      prepared: optional :class:`PreparedQP` from :func:`prepare_qp`.
      have_warm: optional bool (scalar or (B,)): False selects the
        cold-start path even when warm arrays are supplied.

    Returns a :class:`QPSolution` with a leading batch axis (squeezed back if
    the inputs were unbatched).
    """
    full_precision(P.device)
    with _host.span("libmpc.admm.solve"):
        unbatched = q.dim() == 1
        if unbatched:
            q, l, u = q[None], l[None], u[None]
            warm_x = None if warm_x is None else warm_x[None]
            warm_y = None if warm_y is None else warm_y[None]

        dtype = P.dtype
        dev = P.device
        B, n = q.shape
        m = A.shape[0]
        # batched q with shared (m,) bounds: materialize the batch axis so every
        # row operation (including the straggler-compaction gathers) sees (B, m)
        if l.dim() == 1:
            l = l.expand(B, m)
        if u.dim() == 1:
            u = u.expand(B, m)

        # rho_vec is shared across the batch, so per-instance structure must
        # reduce conservatively over the batch: a row gets the fast equality rho
        # only when it is an equality in EVERY instance, and the loose rho only
        # when it is loose in EVERY instance
        if prepared is None:
            if eq_mask is None:
                eq_mask = torch.all((l == u) & torch.isfinite(l), dim=0)
            loose_mask = torch.all((l <= -INF_BOUND) & (u >= INF_BOUND), dim=0)
            q_ref = torch.amax(torch.abs(q), dim=0)
            if axis_batch is not None:
                q_ref = axis_batch.max(q_ref)
            prepared = prepare_qp(P, A, q_ref, eq_mask, loose_mask, params, axis_rows)

        Ps, As = prepared.Ps, prepared.As
        d, e, c = prepared.d, prepared.e, prepared.c
        eq_mask, loose_mask = prepared.eq_mask, prepared.loose_mask
        qs, ls, us = _scale_data(prepared, q, l, u)

        sigma_v, rho_lo, rho_hi = _rho_bounds(dtype, params)
        # cold-solve rho escalation (params.cold_rho): a batch with NO warm lane
        # starts at the stiffer cold rho with its own KKT factor; a batch with
        # any warm lane keeps the warm rho
        rho0 = _scalar(params.rho, P)
        M0_run, Minv0_run = prepared.M0, prepared.Minv0
        if params.cold_rho > 0:
            if have_warm is not None:
                any_warm = _host.flag(torch.as_tensor(have_warm).any())
            else:
                any_warm = warm_x is not None and params.enable_warm_start
            if not any_warm:
                rho0 = torch.clamp(_scalar(params.cold_rho, P), rho_lo, rho_hi)
                with _host.span("libmpc.admm.refactor"):
                    M0_run, Minv0_run = _build_kkt_inverse(
                        Ps, As, _rho_vec_of(rho0, eq_mask, loose_mask), sigma_v, axis_rows
                    )

        y_seed = torch.zeros((B, m), dtype=dtype, device=dev)
        if params.cold_start in ("kkt", "kkt_duals"):
            # seed the cold start at the minimizer of the rho-weighted
            # equality-anchored quadratic model: one ADMM x-update at
            # z = clip(0, l, u), y = 0, against the KKT inverse the cold solve
            # will run with.  Under axis_rows the row product sums over the
            # shards, as every cross-space product does, so x-space quantities
            # replicate from the start (the JAX package leaves this one a
            # shard's partial sum: ROADMAP.md, known reference behaviours)
            rho_vec0 = _rho_vec_of(torch.clamp(rho0, rho_lo, rho_hi), eq_mask, loose_mask)
            z_t = torch.clamp(torch.zeros_like(ls), min=ls, max=us)
            x_seed = (_psum_rows((rho_vec0 * z_t) @ As, axis_rows) - qs) @ Minv0_run
            if params.cold_start == "kkt_duals":
                # the dual step ADMM itself would take from (x_seed, y=0)
                Ax = x_seed @ As.T
                y_seed = rho_vec0 * (Ax - torch.clamp(Ax, min=ls, max=us))
        else:
            x_seed = torch.zeros((B, n), dtype=dtype, device=dev)

        if warm_x is not None and params.enable_warm_start:
            y_warm = (torch.zeros((B, m), dtype=dtype, device=dev) if warm_y is None
                      else warm_y / e[None, :] * c)
            if have_warm is None:
                x0, y0 = warm_x / d[None, :], y_warm
            else:
                # callers that collapse "no warm state yet" into zero arrays pass
                # the flag so the cold branch still gets its seed
                hw = torch.as_tensor(have_warm, device=dev)
                hw2 = hw[..., None] if hw.dim() else hw
                x0 = torch.where(hw2, warm_x / d[None, :], x_seed)
                y0 = torch.where(hw2, y_warm, y_seed)
        else:
            x0, y0 = x_seed, y_seed

        state = _admm_loop(
            Ps, As, qs, ls, us, x0.contiguous(), y0.contiguous(),
            rho0, eq_mask, loose_mask, d, e, c,
            M0_run, Minv0_run, NO_BUDGET if iter_budget is None else iter_budget,
            params, params.maximum_iteration,
            min(params.check_termination, params.maximum_iteration),
            axis_rows, axis_batch,
        )

        sol = _finish(state, prepared, P, A, q, l, u, params, axis_rows)
        if unbatched:
            sol = QPSolution(*(t[0] for t in sol))
        return sol


class _EachData(NamedTuple):
    """The running lanes' scaled problem data in :func:`_admm_loop_each`."""

    P: torch.Tensor  # (B, n, n)
    A: torch.Tensor  # (B, m, n)
    qs: torch.Tensor
    ls: torch.Tensor
    us: torch.Tensor
    eq_mask: torch.Tensor  # (B, m)
    loose_mask: torch.Tensor
    d: torch.Tensor
    e: torch.Tensor
    c: torch.Tensor  # (B,)


def _each_block(state: _LoopState, data: _EachData, params: LParameters,
                check_every: int):
    """One block of the per-lane loop: ``check_every`` ADMM iterations of
    lanes that are all still running (so no freeze mask), then the
    termination check.  Returns (state, adaptive-rho verdict, rho estimate),
    all new tensors: no input is written."""
    sigma_v, _, _ = _rho_bounds(data.P.dtype, params)
    x, z, y = admm_fused.plain_iterations(
        state.x, state.z, state.y, None, data.qs, data.ls, data.us, data.A,
        state.M, state.Minv, _rho_vec_of(state.rho[:, None], data.eq_mask, data.loose_mask),
        sigma=sigma_v, alpha=params.alpha, k_iters=check_every,
        refine=data.P.dtype == torch.float32 and params.x_refine,
    )
    state = state._replace(x=x, z=z, y=y, iters=state.iters + check_every)
    return _termination_check(state, data.P, data.A, data.qs, data.ls, data.us,
                              data.d, data.e, data.c, params)


def _bucket(n: int) -> int:
    """The batch a block graph is captured for: ``n`` lanes rounded up to a
    power of two, so that a few graphs serve every count of running lanes."""
    return 1 << max(n - 1, 0).bit_length()


class _BlockGraph:
    """:func:`_each_block` captured as a CUDA graph for ``size`` lanes: the
    host issues one replay a block where it would issue about 900 launches
    (a float32 UGV subproblem at the 500 cap runs 20 blocks of 25
    iterations).  The state and the lanes' data live in the graph's own
    tensors and a replay advances the state in place; lanes past the
    running count are padding, copies of lane 0 whose results nothing reads.
    A lane's result still depends on the bucket it runs in: cuBLAS picks
    its batched-product kernels by batch size, so on the card a lane's
    rounding changes with the number of lanes still running (about 1e-9 in
    float64 at the UGV shape, and enough in float32 to move a closed loop's
    fractions; on the CPU the lanes are bitwise independent).  Graphs are
    kept for the process, one a (size, shapes, dtype, device, parameters)."""

    _cache: dict = {}

    @classmethod
    def get(cls, size, state, data, params, check_every):
        key = (size, state.x.shape[1:], state.z.shape[1:], state.x.dtype, state.x.device,
               params, check_every)
        graph = cls._cache.get(key)
        if graph is None:
            graph = cls._cache[key] = cls(size, state, data, params, check_every)
        return graph

    def __init__(self, size, state, data, params, check_every):
        empty = lambda t: t.new_empty((size,) + tuple(t.shape[1:]))
        self.size = size
        self.state = _LoopState(*map(empty, state))
        self.data = _EachData(*map(empty, data))
        self.load(state, data)  # the warm-up's inputs
        self.capture(params, check_every)

    def capture(self, params, check_every):
        dev = self.state.x.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            _each_block(self.state, self.data, params, check_every)  # warm-up
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.need_update, self.rho_est = self.advance(params, check_every)

    def advance(self, params, check_every):
        """One block on the graph's tensors, the state written back in place
        (the fields the block changed: rho, M and Minv it returns as they
        were, and refactorizations write them in place between replays)."""
        new, need_update, rho_est = _each_block(self.state, self.data, params, check_every)
        for buf, val in zip(self.state, new):
            if val is not buf:
                buf.copy_(val)
        return need_update, rho_est

    def load(self, state, data):
        """Copy ``state`` and ``data`` (their first axis the running lanes)
        into the graph's tensors, padding with lane 0."""
        n = state.x.shape[0]
        for buf, val in zip(self.state + self.data, state + data):
            buf[:n].copy_(val)
            if n < self.size:
                buf[n:].copy_(val[:1].expand((self.size - n,) + tuple(val.shape[1:])))

    def run(self):
        self.graph.replay()
        return self.state, self.need_update, self.rho_est


def _use_graphs(device) -> bool:
    """Whether :func:`_admm_loop_each` replays its blocks as CUDA graphs:
    on the card, where a block's launches cost the host more than the
    device's work; the CPU runs them eagerly."""
    return device.type == "cuda"


def _admm_loop_each(P, A, qs, ls, us, x0, y0, eq_mask, loose_mask, d, e, c,
                    rho0, M0, Minv0, params: LParameters, n_iters: int,
                    check_every: int) -> _LoopState:
    """The scaled-problem ADMM iterations of :func:`admm_solve_each`: one
    (P, A), scaling, rho and KKT inverse a lane (``P`` (B, n, n), ``A``
    (B, m, n), ``d`` (B, n), ``e`` (B, m), ``c``/``rho0`` (B,), ``M0``/
    ``Minv0`` (B, n, n)).

    Each lane runs the loop it would run alone: blocks of ``check_every``
    iterations, a termination check after each, and its own stop at its own
    verdict or at the block cap.  The lanes are independent, so the loop
    works on the lanes still running only: when a check finishes some, their
    final state is written back and the rest are gathered into a smaller
    batch (the iteration then needs no freeze mask).  A lane whose
    adaptive-rho test passes gets its KKT inverse rebuilt, and only those
    lanes are refactorized (under the JAX package's vmap the ``lax.cond``
    becomes a select that computes it for every lane and keeps it for
    these).  One read from the device a block, the counts of finished lanes
    and of refactorizations, and one for each index set of lanes that a
    block refactorizes, finishes or keeps (all through ``_host``).

    On the card (:func:`_use_graphs`) each block replays as a CUDA graph
    (:class:`_BlockGraph`) instead of launching its kernels one by one.  The
    graph's batch is the running lanes padded to a power of two, and cuBLAS
    chooses its kernels by batch, so a lane's rounding there is not that of
    the eager loop's batch (see :class:`_BlockGraph`).
    """
    B = qs.shape[0]
    dtype, dev = P.dtype, P.device
    sigma_v, _, _ = _rho_bounds(dtype, params)

    def full(v, dt):
        return torch.full((B,), v, dtype=dt, device=dev)

    state = _LoopState(
        x=x0, z=_mm(x0, A.mT), y=y0, x_prev=x0, y_prev=y0,
        iters=full(0, torch.int32),
        done=full(False, torch.bool),
        status=full(OSQP_UNSOLVED, torch.int32),
        pri_res=full(float("inf"), dtype),
        dua_res=full(float("inf"), dtype),
        inacc_status=full(OSQP_MAX_ITER_REACHED, torch.int32),
        pri_chk=full(float("inf"), dtype),
        dua_chk=full(float("inf"), dtype),
        stall_ct=full(0, torch.int32),
        rho=rho0, M=M0, Minv=Minv0,
    )
    data = _EachData(P, A, qs, ls, us, eq_mask, loose_mask, d, e, c)
    out = state
    lanes = torch.arange(B, device=dev)  # the original index of each running lane
    graph = None
    if _use_graphs(dev):
        with _host.span("libmpc.admm_each.compact"):
            graph = _BlockGraph.get(_bucket(B), state, data, params, check_every)
            graph.load(state, data)
    n_blocks = max(1, (n_iters + check_every - 1) // check_every)
    for k in range(n_blocks):
        n = lanes.numel()
        with _host.span("libmpc.admm_each.block"):
            if graph is None:
                state, need_update, rho_est = _each_block(state, data, params, check_every)
            else:
                # the graph's tensors hold the n running lanes first
                state, need_update, rho_est = graph.run()
                state = _LoopState(*(t[:n] for t in state))
                need_update, rho_est = need_update[:n], rho_est[:n]
                data = _EachData(*(t[:n] for t in graph.data))
            n_done, n_update = _host.values(torch.stack([state.done.sum(), need_update.sum()]))
        if n_update:
            with _host.span("libmpc.admm_each.refactor"):
                iu = _host.nonzero(need_update)
                rho_u = rho_est[iu]
                M_u, Minv_u = _build_kkt_inverse(
                    data.P[iu], data.A[iu],
                    _rho_vec_of(rho_u[:, None], data.eq_mask[iu], data.loose_mask[iu]), sigma_v,
                )
                if graph is None:
                    state = state._replace(
                        rho=state.rho.index_copy(0, iu, rho_u),
                        M=state.M.index_copy(0, iu, M_u),
                        Minv=state.Minv.index_copy(0, iu, Minv_u),
                    )
                else:  # in place, in the graph's tensors
                    state.rho.index_copy_(0, iu, rho_u)
                    state.M.index_copy_(0, iu, M_u)
                    state.Minv.index_copy_(0, iu, Minv_u)
        last = k == n_blocks - 1 or n_done == n
        if n_done or last:
            with _host.span("libmpc.admm_each.compact"):
                fin = _host.nonzero(torch.ones_like(state.done) if last else state.done)
                out = out._replace(**{
                    f: getattr(out, f).index_copy(0, lanes[fin], getattr(state, f)[fin])
                    for f in _LANE_FIELDS
                })
                if last:
                    break
                keep = _host.nonzero(~state.done)
                state = _LoopState(*(t[keep] for t in state))
                data = _EachData(*(t[keep] for t in data))
                lanes = lanes[keep]
                if graph is not None:
                    graph = _BlockGraph.get(_bucket(keep.numel()), state, data, params,
                                            check_every)
                    graph.load(state, data)
    # lanes that never converged report the relaxed-tolerance verdict of
    # their final check
    status = torch.where(out.status == OSQP_UNSOLVED, out.inacc_status, out.status)
    return out._replace(status=status)


def admm_solve_each(
    P: torch.Tensor,
    A: torch.Tensor,
    q: torch.Tensor,
    l: torch.Tensor,
    u: torch.Tensor,
    params: LParameters = LParameters(),
    warm_x: Optional[torch.Tensor] = None,
    warm_y: Optional[torch.Tensor] = None,
    eq_mask: Optional[torch.Tensor] = None,
) -> QPSolution:
    """Solve a batch of QPs, each with its own (P, A): lane b computes what
    :func:`admm_solve` computes for instance b alone (the JAX package's
    ``jax.vmap(admm_solve)`` over unbatched instances: the SQP's inner
    ``"admm"`` engine, ``libmpc_tpu/ops/sqp.py:617-635``).

    Args:
      P: (B, n, n) quadratic costs (full symmetric).
      A: (B, m, n) constraint matrices.
      q, l, u: (B, n) / (B, m).
      params: OSQP-style settings.
      warm_x, warm_y: optional warm-start primal/dual, shaped like q / l.
      eq_mask: optional (m,) or (B, m) bool marking structural equality
        rows; each lane's own ``l == u`` rows when omitted.

    Everything the shared-(P, A) solve reduces over the batch is the lane's
    own here: the equality and loose masks, the cost-scaling reference
    ``|q|``, the Ruiz scalings d (B, n), e (B, m), c (B,), rho (B,) and the
    KKT matrix and inverse (B, n, n), built by the batched inverse kernel K2
    (:func:`_build_kkt_inverse`) and rebuilt, lane by lane, when a lane's
    adaptive-rho test passes (see :func:`_admm_loop_each`).  The shared
    polish runs on each lane's own base inverse pair.  There is no
    straggler compaction (the JAX package compacts only batches of 256 and
    more, and each instance is a batch of one) and no iteration budget.  A
    lane starts from ``warm_x``/``warm_y`` or from zeros: ``cold_start``
    and ``cold_rho``, which only the shared-(P, A) LMPC uses, are not read.

    ``admm_solve_each.trace``, when a list, collects (iters, status) of each
    call, both (B,).
    """
    full_precision(P.device)
    dtype, dev = P.dtype, P.device
    B, n = q.shape
    m = A.shape[-2]
    if eq_mask is None:
        eq_mask = (l == u) & torch.isfinite(l)
    eq_mask = eq_mask.expand(B, m)
    loose_mask = (l <= -INF_BOUND) & (u >= INF_BOUND)

    # -- setup, each lane its own (prepare_qp of a batch of one) ----------
    prep = prepare_qp(P, A, torch.abs(q), eq_mask, loose_mask, params)
    d, e, c = prep.d, prep.e, prep.c
    qs, ls, us = _scale_data(prep, q, l, u)
    _, rho_lo, rho_hi = _rho_bounds(dtype, params)
    rho0 = torch.clamp(_scalar(params.rho, P), rho_lo, rho_hi).expand(B).contiguous()

    zeros = lambda k: torch.zeros((B, k), dtype=dtype, device=dev)
    if warm_x is not None and params.enable_warm_start:
        x0 = warm_x / d
        y0 = zeros(m) if warm_y is None else warm_y / e * c[:, None]
    else:
        x0, y0 = zeros(n), zeros(m)

    state = _admm_loop_each(
        prep.Ps, prep.As, qs, ls, us, x0, y0, eq_mask, loose_mask, d, e, c,
        rho0, prep.M0, prep.Minv0, params, params.maximum_iteration,
        min(params.check_termination, params.maximum_iteration),
    )
    sol = _finish(state, prep, P, A, q, l, u, params)
    if admm_solve_each.trace is not None:
        admm_solve_each.trace.append((sol.iters, sol.status))
    return sol


admm_solve_each.trace = None
