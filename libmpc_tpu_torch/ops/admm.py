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

Status codes reuse OSQP's integer values so ``Result.solver_status`` is
directly comparable with the reference's
(reference: include/mpc/LMPC/LOptimizer.hpp:386-415).  The JAX package's
row-sharded and batch-sharded layouts (``axis_rows``/``axis_batch``) are
not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..types import LParameters
from . import admm_fused, batched_linalg

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


def _ruiz_equilibration(P, A, q_ref, iters: int):
    """Modified Ruiz equilibration of the KKT-stacked matrix (OSQP scaling.c).

    Returns diagonal scalings ``d`` (n,), ``e`` (m,) and cost scaling ``c``
    such that the scaled problem is ``(c d P d, c d q, e A d, e l, e u)``.
    ``q_ref`` is a representative linear term (batch max-abs) used only for
    the cost scaling; it does not affect the fixed point being computed.
    """
    kw = dict(dtype=P.dtype, device=P.device)
    d = torch.ones((P.shape[0],), **kw)
    e = torch.ones((A.shape[0],), **kw)
    c = torch.ones((), **kw)
    q = q_ref

    def limit(norm):
        # OSQP scaling.c limit_scaling: degenerate (near-zero) norms scale by
        # 1.0 — essential for structurally-zero rows, which would otherwise
        # blow the scaling up by 1e6 per Ruiz sweep
        return torch.where(norm < 1e-4, 1.0, torch.clamp(norm, max=1e4))

    for _ in range(iters):
        # column inf-norms of the stacked [[P, A'], [A, 0]]
        col_norm_x = torch.maximum(_inf_norm(P, dim=0), _inf_norm(A, dim=0))
        col_norm_y = _inf_norm(A, dim=1)
        dd = 1.0 / torch.sqrt(limit(col_norm_x))
        ee = 1.0 / torch.sqrt(limit(col_norm_y))
        P = P * dd[None, :] * dd[:, None]
        A = A * ee[:, None] * dd[None, :]
        q = q * dd
        # cost normalization (OSQP: gamma = 1/max(mean colnorm P, ||q||inf))
        mean_col_p = torch.mean(_inf_norm(P, dim=0))
        gamma = 1.0 / limit(torch.maximum(mean_col_p, _inf_norm(q)))
        P = P * gamma
        q = q * gamma
        d, e, c = d * dd, e * ee, c * gamma
    return d, e, c


class PreparedQP(NamedTuple):
    """Time-invariant solver state hoisted out of the per-step solve
    (OSQP's setup-once semantics; ``libmpc_tpu/ops/admm.py:166``)."""

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
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


def prepare_qp(P, A, q_ref, eq_mask, loose_mask,
               params: LParameters) -> PreparedQP:
    """One-time setup: Ruiz equilibration + initial KKT inverse.

    ``q_ref`` is a representative linear term used only for the cost
    scaling (OSQP computes it from the q present at ``osqp_setup`` and keeps
    it when q is later updated — the same stale-c semantics apply here).
    """
    full_precision(P.device)
    n, m = P.shape[0], A.shape[0]
    kw = dict(dtype=P.dtype, device=P.device)
    if params.scaling_iters > 0:
        d, e, c = _ruiz_equilibration(P, A, q_ref, params.scaling_iters)
    else:
        d, e, c = torch.ones((n,), **kw), torch.ones((m,), **kw), torch.ones((), **kw)
    Ps = c * (P * d[None, :] * d[:, None])
    As = A * e[:, None] * d[None, :]
    sigma_v, rho_lo, rho_hi = _rho_bounds(P.dtype, params)
    rho_init = torch.clamp(_scalar(params.rho, P), rho_lo, rho_hi)
    M0, Minv0 = _build_kkt_inverse(
        Ps, As, _rho_vec_of(rho_init, eq_mask, loose_mask), sigma_v
    )
    # the shared-polish base inverse is only built when these params will
    # run that polish; admm_solve builds it on the fly otherwise
    if params.polish and params.polish_mode == "shared":
        Mpinv, Mpinv_lo = _polish_prep(P, A, eq_mask)
    else:
        Mpinv = Mpinv_lo = None
    return PreparedQP(
        Ps=Ps, As=As, d=d, e=e, c=c, eq_mask=eq_mask, loose_mask=loose_mask,
        M0=M0, Minv0=Minv0, Mpinv=Mpinv, Mpinv_lo=Mpinv_lo,
    )


def _polish_prep(P, A, eq_mask):
    """Shared-polish base inverse pair (hi, lo) on the UNSCALED problem
    (the polish operates unscaled): equality rows are active in every
    instance.

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
    n = P.shape[0]
    dtype = P.dtype
    delta = _polish_delta_shared(dtype)
    if dtype == torch.float32:
        P64, A64 = P.double(), A.double()
        w64 = eq_mask.double() / delta
        Mp64 = (P64 + delta * torch.eye(n, dtype=torch.float64, device=P.device)
                + (A64.T * w64[None, :]) @ A64)
        inv = torch.cholesky_inverse(torch.linalg.cholesky(Mp64))
        hi = inv.float()
        return hi, (inv - hi.double()).float()
    eye = torch.eye(n, dtype=dtype, device=P.device)
    w_eq = eq_mask.to(dtype) / delta
    Mp = P + delta * eye + (A.T * w_eq[None, :]) @ A
    # kappa(Mp) ~ 1/delta^2 overwhelms a raw float32 Cholesky; the spread
    # is diagonal-structural, so Jacobi scaling tames it, and two Newton
    # passes X <- X(2I - Ms X) square the factorization residual down to
    # the float32 floor
    s = torch.rsqrt(torch.clamp(torch.diagonal(Mp), min=1e-30))
    Ms = Mp * s[:, None] * s[None, :]
    Msinv = torch.cholesky_inverse(torch.linalg.cholesky(Ms))
    for _ in range(2):
        Msinv = Msinv @ (2.0 * eye - Ms @ Msinv)
    Mpinv = Msinv * s[:, None] * s[None, :]
    # double-single low word: E = I - Mp Mpinv via a compensated product,
    # then lo = Mpinv E; applying (Mpinv + Mpinv_lo) removes the eps.kappa
    # systematic error of the stored float32 inverse
    e_hi, e_lo = _comp_mm(Mp, Mpinv)
    E = (eye - e_hi) - e_lo
    Mpinv_lo = Mpinv @ E
    return Mpinv, Mpinv_lo


def _build_kkt_inverse(P, A, rho_vec, sigma):
    """Explicit inverse (and the matrix itself) of
    M = P + sigma*I + A' diag(rho) A.

    An explicit inverse turns every ADMM x-update into a plain matrix
    product.  M is returned too so float32 runs can refine the x-update
    against it.  One shared (n, n) Cholesky: a library factorization, not a
    kernel of this port.
    """
    eye = torch.eye(P.shape[0], dtype=P.dtype, device=P.device)
    M = P + sigma * eye + (A.T * rho_vec[None, :]) @ A
    Minv = batched_linalg.spd_inverse(M).contiguous()
    return M, Minv


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
    rho: torch.Tensor  # () shared across the batch
    M: torch.Tensor
    Minv: torch.Tensor


# per-lane fields of _LoopState (gathered by straggler compaction)
_LANE_FIELDS = ("x", "z", "y", "x_prev", "y_prev", "iters", "done", "status",
                "pri_res", "dua_res", "inacc_status", "pri_chk", "dua_chk",
                "stall_ct")


def _termination_check(state: _LoopState, P, A, qs, ls, us, d, e, c,
                       params: LParameters):
    """OSQP's periodic check on the unscaled residuals: convergence,
    infeasibility certificates, the relaxed verdict a max-iteration exit
    would report, float32 stall detection and the adaptive-rho estimate.

    Returns the updated state, the adaptive-rho verdict and the rho
    estimate (0-d tensors, still on the device).
    """
    f32 = P.dtype == torch.float32
    _, rho_lo, rho_hi = _rho_bounds(P.dtype, params)
    x, z, y = state.x, state.z, state.y
    # -- unscaled residuals ------------------------------------------
    Ax = x @ A.T
    Px = x @ P
    Aty = y @ A
    pri = _inf_norm((Ax - z) / e[None, :])
    dua = _inf_norm((Px + qs + Aty) / d[None, :]) / c
    pri_rel = torch.maximum(_inf_norm(Ax / e[None, :]), _inf_norm(z / e[None, :]))
    dua_rel = torch.maximum(
        torch.maximum(_inf_norm(Px / d[None, :]), _inf_norm(Aty / d[None, :])),
        _inf_norm(qs / d[None, :]),
    ) / c
    eps_pri = params.eps_abs + params.eps_rel * pri_rel
    eps_dua = params.eps_abs + params.eps_rel * dua_rel
    solved = (pri <= eps_pri) & (dua <= eps_dua)

    # -- infeasibility certificates (unscaled deltas) ----------------
    # unscaling: x = D x_bar, y = c^-1 E y_bar
    dy = (y - state.y_prev) * e[None, :] / c
    dx = (x - state.x_prev) * d[None, :]
    norm_dy = _inf_norm(dy)
    norm_dx = _inf_norm(dx)

    # primal infeasibility: ||A' dy|| small and support function negative
    Atdy = _inf_norm(((y - state.y_prev) @ A) / d[None, :]) / c
    u_unscaled = us / e[None, :]
    l_unscaled = ls / e[None, :]
    dy_plus = torch.clamp(dy, min=0.0)
    dy_minus = torch.clamp(dy, max=0.0)
    # the where() keeps 0 * (+-1e30) bounds out of the sum on rows
    # whose dual did not move that way
    sup = torch.sum(
        torch.where(dy_plus > 0, torch.clamp(u_unscaled, max=INF_BOUND) * dy_plus, 0.0)
        + torch.where(dy_minus < 0, torch.clamp(l_unscaled, min=-INF_BOUND) * dy_minus, 0.0),
        dim=-1,
    )
    # OSQP auxil.c is_primal_infeasible: ||dy|| > eps, support function
    # strictly negative, and A'dy ~ 0
    eps_p = params.eps_prim_inf * norm_dy
    prim_inf = (norm_dy > params.eps_prim_inf) & (sup < -eps_p) & (Atdy < eps_p)

    # dual infeasibility: P dx ~ 0, q'dx < 0, A dx in recession cone
    Pdx = _inf_norm((dx / d[None, :]) @ P / d[None, :]) / c
    qdx = torch.sum(qs / d[None, :] * dx, dim=-1) / c
    Adx = (dx / d[None, :]) @ A.T / e[None, :]
    u_inf = u_unscaled >= INF_BOUND
    l_inf = l_unscaled <= -INF_BOUND

    def cone_recession(eps_d):
        ed = eps_d[:, None]
        inside = torch.where(
            u_inf, Adx >= -ed,
            torch.where(l_inf, Adx <= ed, torch.abs(Adx) <= ed),
        )
        return torch.all((u_inf & l_inf) | inside, dim=-1)

    def is_dual_infeasible(eps_dual_inf):
        # OSQP auxil.c is_dual_infeasible: ||dx|| > eps, q'dx strictly
        # negative, P dx ~ 0, and A dx in the recession cone
        eps_d = eps_dual_inf * norm_dx
        return ((norm_dx > eps_dual_inf) & (Pdx < eps_d) & (qdx < -eps_d)
                & cone_recession(eps_d))

    dual_inf = is_dual_infeasible(params.eps_dual_inf)

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
    dual_inf_inacc = is_dual_infeasible(fac * params.eps_dual_inf)
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

    # -- adaptive rho (shared across batch to keep one shared factor) -
    if params.adaptive_rho:
        ratio = torch.sqrt(torch.clamp(
            (pri / torch.clamp(pri_rel, min=1e-12))
            / torch.clamp(dua / torch.clamp(dua_rel, min=1e-12), min=1e-12),
            1e-10, 1e10,
        ))
        ratio = torch.nan_to_num(ratio, nan=1.0, posinf=1e10, neginf=1e-10)
        # geometric mean over still-active instances
        active = ~done
        log_sum = torch.sum(torch.where(active, torch.log(ratio), 0.0))
        n_act = torch.sum(active)
        rho_est = state.rho * torch.exp(log_sum / torch.clamp(n_act, min=1))
        rho_est = torch.clamp(torch.nan_to_num(rho_est, nan=rho_lo), rho_lo, rho_hi)
        need_update = (n_act > 0) & (
            (rho_est > state.rho * ADAPTIVE_RHO_TOLERANCE)
            | (rho_est < state.rho / ADAPTIVE_RHO_TOLERANCE)
        )
    else:
        rho_est = state.rho
        need_update = torch.zeros((), dtype=torch.bool, device=P.device)

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


def _admm_loop(P, A, qs, ls, us, x0, y0, rho0, rho_mask_eq, rho_mask_loose,
               d, e, c, M0, Minv0, iter_budget: int, params: LParameters,
               n_iters: int, check_every: int) -> _LoopState:
    """Scaled-problem ADMM iterations with periodic termination checks.

    All of P/A/q/l/u here are the *scaled* quantities; d/e/c unscale
    residuals for termination (OSQP checks unscaled residuals by default).
    ``M0``/``Minv0`` are the KKT matrix/inverse at the initial rho.

    ``iter_budget`` is an iteration cap implementing the ``time_limit``
    contract: the loop stops at the first termination check past the
    budget and unconverged instances report ``OSQP_TIME_LIMIT_REACHED``.
    Pass ``NO_BUDGET`` for no limit.
    """
    B = qs.shape[0]
    dtype = P.dtype
    dev = P.device
    f32 = dtype == torch.float32
    sigma_v, rho_lo, rho_hi = _rho_bounds(dtype, params)
    refine = f32 and params.x_refine
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

    def block(state: _LoopState, qs, ls, us):
        """One iteration block + termination check.  Returns the new state,
        whether every lane is done and the count of active lanes (one
        device-to-host read per block)."""
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
        state, need_update, rho_est = _termination_check(
            state, P, A, qs, ls, us, d, e, c, params
        )
        all_done, update, n_active = torch.stack([
            state.done.all().long(), need_update.long(), (~state.done).sum(),
        ]).tolist()
        if update:
            M, Minv = _build_kkt_inverse(P, A, rho_vec_of(rho_est), sigma_v)
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
    compact = params.compact_stragglers and cap < B and B >= 256

    k, stop, n_active = 0, False, B
    while go_on(k, stop) and (not compact or n_active > cap):
        state, stop, n_active = block(state, qs, ls, us)
        k += 1

    if compact and go_on(k, stop):
        # unconverged lanes first; ties among done lanes are harmless
        _, idx = torch.topk((~state.done).to(torch.float32), cap)
        sub = state._replace(**{f: getattr(state, f)[idx] for f in _LANE_FIELDS})
        qs_c, ls_c, us_c = qs[idx], ls[idx], us[idx]
        while go_on(k, stop):
            sub, stop, _ = block(sub, qs_c, ls_c, us_c)
            k += 1
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
    the result and go straight into the low word.  Depends on IEEE order of
    the elementwise operations: eager PyTorch keeps it (do not compile
    this)."""
    Xh, Xl = _split12(X)
    Mh, Ml = _split12(M)
    K = M.shape[0]
    hi = None
    lo = 0.0
    for c0 in range(0, K, chunk):
        p = Xh[..., c0 : c0 + chunk] @ Mh[c0 : c0 + chunk, :]
        if hi is None:
            hi = p
        else:
            hi, e = _two_sum(hi, p)
            lo = lo + e
    lo = lo + (X @ Ml + Xl @ Mh)
    return hi, lo


def _polish_active_set(l, u, sol_y, eq_mask, dtype, delta):
    """Active rows from dual signs (OSQP polish.c) -> (active, b, w)."""
    low_active = (sol_y < 0) | (eq_mask[None, :] & (sol_y <= 0))
    upp_active = sol_y > 0
    active = low_active | upp_active
    b = torch.where(low_active, l, torch.where(upp_active, u, 0.0))
    w = active.to(dtype) / delta  # (B, m) row weights
    return active, b, w


def _polish_accept(P, A, q, l, u, sol_x, sol_y, sol_z, x_pol, y_pol, active):
    """Per-instance acceptance: keep the polished solution only if it
    reduces both residual norms (OSQP polish.c:polish())."""
    y_pol = torch.where(active, y_pol, 0.0)
    z_pol = torch.clamp(x_pol @ A.T, min=l, max=u)

    def residuals(x, z, y):
        pri = _inf_norm(x @ A.T - z)
        dua = _inf_norm(x @ P + q + y @ A)
        return pri, dua

    pri0, dua0 = residuals(sol_x, sol_z, sol_y)
    pri1, dua1 = residuals(x_pol, z_pol, y_pol)
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
                   eq_mask, prepared: PreparedQP):
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
    caught by the acceptance test (kept unpolished).
    """
    dtype = P.dtype
    m = A.shape[0]
    delta = _polish_delta_shared(dtype)
    outer_iters = max(6, params.polish_refine_iter)
    k_max = min(params.polish_active_cap, m)
    Mpinv = prepared.Mpinv
    Mpinv_lo = prepared.Mpinv_lo

    def mp_solve(r):
        # the double-single inverse pair: two plain products
        return r @ Mpinv + r @ Mpinv_lo

    active, bnd, w = _polish_active_set(l, u, sol_y, eq_mask, dtype, delta)

    # per-instance indices of the active inequality rows, padded with
    # inactive rows masked out of the capacitance (torch.topk breaks ties
    # in another order than lax.top_k: C comes out permuted, the solve is
    # the same up to rounding)
    extra = active & ~eq_mask[None, :]
    _, idx = torch.topk(extra.to(dtype), k_max, dim=-1)  # (B, k)
    valid = torch.gather(extra, -1, idx)  # (B, k)
    A_g = torch.where(valid[:, :, None], A[idx], 0.0)  # (B, k, n), masked rows zeroed

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
        dx = K_solve(r1 + (w * r2) @ A)
        dnu = w * (dx @ A.T - r2)
        return x + dx, nu + dnu, dx, dnu

    def plain(x, nu):
        r1 = -q - x @ P - torch.where(active, nu, 0.0) @ A
        r2 = torch.where(active, bnd - x @ A.T, 0.0)
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
        h3, l3 = _comp_mm(x, A.T)
        bnd_m = torch.where(active, bnd, 0.0)
        s3, e3 = _two_sum(bnd_m, -h3)
        r2 = torch.where(active, s3 + (e3 - l3), 0.0)
        for _ in range(max(params.polish_comp_passes, 0)):
            x, nu, dx, dnu = correct(x, nu, r1, r2)
            r1 = r1 - dx @ P - dnu @ A
            r2 = torch.where(active, r2 - dx @ A.T, 0.0)
        x_pol, y_pol = x, nu
    else:
        for _ in range(outer_iters):
            x, nu = plain(x, nu)
        x_pol, y_pol = x, nu
    return _polish_accept(P, A, q, l, u, sol_x, sol_y, sol_z, x_pol, y_pol, active)


def _polish(P, A, q, l, u, sol_x, sol_y, sol_z, params: LParameters, eq_mask):
    """Active-set polish (OSQP polish.c, penalty/Schur-complement form) with
    per-instance dense factorizations (``libmpc_tpu/ops/admm.py:1067``).

    Solves the stabilized equality-constrained QP of each instance::

        (P + delta I + A_act' (1/delta) A_act) x = -q + A_act' b / delta

    with a fixed (n, n) shape (active sets enter as per-instance 0/1 row
    weights), then refines against the unregularized KKT system.
    """
    dtype = P.dtype
    n = P.shape[1]
    f32 = dtype == torch.float32
    delta = _polish_delta(dtype)
    refine_iters = (max(params.polish_refine_iter, 15) if f32
                    else params.polish_refine_iter)

    active, b, w = _polish_active_set(l, u, sol_y, eq_mask, dtype, delta)
    eye = torch.eye(n, dtype=dtype, device=P.device)
    M = P + delta * eye + A.T @ (w[:, :, None] * A)  # (B, n, n)
    L = torch.linalg.cholesky(M)

    def cho_solve(r):
        return torch.cholesky_solve(r[:, :, None], L)[..., 0]

    x = cho_solve(-q + (w * b) @ A)
    nu = w * (x @ A.T - b)
    for _ in range(refine_iters):
        r1 = -q - x @ P - torch.where(active, nu, 0.0) @ A
        r2 = torch.where(active, b - x @ A.T, 0.0)
        dx = cho_solve(r1 + (w * r2) @ A)
        dnu = w * (dx @ A.T - r2)
        x, nu = x + dx, nu + dnu
    return _polish_accept(P, A, q, l, u, sol_x, sol_y, sol_z, x, nu, active)


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
) -> QPSolution:
    """Solve a batch of QPs sharing (P, A) structure.

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
        prepared = prepare_qp(P, A, q_ref, eq_mask, loose_mask, params)

    Ps, As = prepared.Ps, prepared.As
    d, e, c = prepared.d, prepared.e, prepared.c
    eq_mask, loose_mask = prepared.eq_mask, prepared.loose_mask
    qs = c * (q * d[None, :])
    # scale bounds, keeping infinities infinite
    ls = torch.where(l <= -INF_BOUND, l, l * e[None, :])
    us = torch.where(u >= INF_BOUND, u, u * e[None, :])

    sigma_v, rho_lo, rho_hi = _rho_bounds(dtype, params)
    # cold-solve rho escalation (params.cold_rho): a batch with NO warm lane
    # starts at the stiffer cold rho with its own KKT factor; a batch with
    # any warm lane keeps the warm rho
    rho0 = _scalar(params.rho, P)
    M0_run, Minv0_run = prepared.M0, prepared.Minv0
    if params.cold_rho > 0:
        if have_warm is not None:
            any_warm = bool(torch.as_tensor(have_warm).any())
        else:
            any_warm = warm_x is not None and params.enable_warm_start
        if not any_warm:
            rho0 = torch.clamp(_scalar(params.cold_rho, P), rho_lo, rho_hi)
            M0_run, Minv0_run = _build_kkt_inverse(
                Ps, As, _rho_vec_of(rho0, eq_mask, loose_mask), sigma_v
            )

    y_seed = torch.zeros((B, m), dtype=dtype, device=dev)
    if params.cold_start in ("kkt", "kkt_duals"):
        # seed the cold start at the minimizer of the rho-weighted
        # equality-anchored quadratic model: one ADMM x-update at
        # z = clip(0, l, u), y = 0, against the KKT inverse the cold solve
        # will run with
        rho_vec0 = _rho_vec_of(torch.clamp(rho0, rho_lo, rho_hi), eq_mask, loose_mask)
        z_t = torch.clamp(torch.zeros_like(ls), min=ls, max=us)
        x_seed = ((rho_vec0 * z_t) @ As - qs) @ Minv0_run
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
    )

    # -- unscale ----------------------------------------------------------
    x = state.x * d[None, :]
    y = state.y * e[None, :] / c
    z = state.z / e[None, :]
    pri_res, dua_res = state.pri_res, state.dua_res

    if params.polish:
        if params.polish_mode == "shared":
            if prepared.Mpinv is None:
                # prepared cache built under no-polish params
                mp_hi, mp_lo = _polish_prep(P, A, eq_mask)
                prepared = prepared._replace(Mpinv=mp_hi, Mpinv_lo=mp_lo)
            x_p, y_p, z_p, pri_p, dua_p = _polish_shared(
                P, A, q, l, u, x, y, z, params, eq_mask, prepared
            )
        else:
            x_p, y_p, z_p, pri_p, dua_p = _polish(
                P, A, q, l, u, x, y, z, params, eq_mask
            )
        ok = (state.status == OSQP_SOLVED) | (state.status == OSQP_SOLVED_INACCURATE)
        sel = ok[:, None]
        x = torch.where(sel, x_p, x)
        y = torch.where(sel, y_p, y)
        z = torch.where(sel, z_p, z)
        pri_res = torch.where(ok, pri_p, pri_res)
        dua_res = torch.where(ok, dua_p, dua_res)

    obj = 0.5 * torch.sum((x @ P) * x, dim=-1) + torch.sum(q * x, dim=-1)

    sol = QPSolution(
        x=x, y=y, z=z, status=state.status, iters=state.iters, obj_val=obj,
        pri_res=pri_res, dua_res=dua_res,
    )
    if unbatched:
        sol = QPSolution(*(t[0] for t in sol))
    return sol
