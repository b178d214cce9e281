"""Analytic FLOP and byte models of the solvers.

These models count the *useful algorithm FLOPs* of each solver's dominant
dense-algebra terms (matrix-product-level operations; elementwise vector work
and control flow excluded), so ``flops / time`` is a lower bound on the
sustained rate, and the bytes an instance must move between device memory
and the kernels, so ``bytes / time`` is a lower bound on the traffic rate.
Multiplied by the batch and the measured iteration counts, and divided by a
card's peak rates, they give the least time a solve could take.

The formulas are the JAX package's (``libmpc_tpu/utils/flops.py``), kept
equal so that bounds computed for the two packages compare.

Models (per instance, per iteration; B and measured iteration counts
multiply in the caller):

* ADMM iteration (``ops/admm.py`` and the K1 block ``ops/admm_fused.py``,
  shared KKT inverse): rhs build ``(rho z - y) @ A`` = 2mn, x-update
  ``rhs @ Minv`` = 2n^2, refinement pass ``xt @ M`` + ``· @ Minv`` = 4n^2,
  ``xt @ A.T`` = 2mn  ->  4mn + 6n^2 (+2n^2 without refinement).
* ADMM termination check (every ``check_termination`` iterations):
  Ax, Px, A'y, A'dy, P dx, A dx ~ 6 matvecs -> 8mn + 4n^2.
* Banded interior-point SQP iteration (``ops/trajectory_kkt.py``, per inner
  iteration): Gram assembly 6·mi·bs_p^2·ph, stage factorization
  ~14·ph·bs^3 (K4: two SPD inverses and block products a stage), 3 solve
  sweeps ~12·ph·bs^2·(2+w) (K5), residual matvecs 4·(me+mi)·nz.
* SQP outer iteration extras: exact Jacobians by forward mode over nz
  tangents ~ 2·nz·(me+mi)·c_model with c_model ~ 3 operations an output,
  line search and merit ~ (me+mi)·nz.
"""

from __future__ import annotations


def admm_iter_flops(n: int, m: int, x_refine: bool = True) -> float:
    """FLOPs of one ADMM iteration for one instance (shared (n,n)/(m,n))."""
    base = 4.0 * m * n + 2.0 * n * n
    if x_refine:
        base += 4.0 * n * n
    return base


def admm_check_flops(n: int, m: int) -> float:
    """FLOPs of one termination check for one instance."""
    return 8.0 * m * n + 4.0 * n * n


def admm_solve_flops(n: int, m: int, iters: float, check_every: int,
                     x_refine: bool = True) -> float:
    """Useful FLOPs of one ADMM solve at a measured iteration count."""
    checks = max(iters / max(check_every, 1), 1.0)
    return iters * admm_iter_flops(n, m, x_refine) + checks * admm_check_flops(n, m)


def traj_ipm_iter_flops(ph: int, ch: int, nx: int, nu: int, mi: int) -> float:
    """FLOPs of one banded interior-point (Mehrotra) iteration for one
    instance."""
    bs_p = nx + nu
    bs = bs_p + nx
    w = nu + 2
    me = ph * nx
    nz = ph * nx + ch * nu + 1
    gram = 6.0 * mi * bs_p * bs_p * ph
    factor = 14.0 * ph * bs**3
    sweeps = 12.0 * ph * bs * bs * (2 + w)
    resid = 4.0 * (me + mi) * nz
    return gram + factor + sweeps + resid


def sqp_iter_flops(ph: int, ch: int, nx: int, nu: int, mi: int,
                   ipm_iters: float = 20.0) -> float:
    """FLOPs of one SQP iteration with the banded interior-point engine."""
    nz = ph * nx + ch * nu + 1
    me = ph * nx
    jac = 2.0 * nz * (me + mi) * 3.0
    merit = 2.0 * (me + mi) * nz
    return jac + merit + ipm_iters * traj_ipm_iter_flops(ph, ch, nx, nu, mi)


def fused_sqp_iter_flops(nz: int, me: int, mi: int,
                         admm_iters: float = 60.0) -> float:
    """FLOPs of one SQP iteration with the fused inner-QP engine (K3, small
    problems): per inner iteration ~ 4 m_qp nz + 2 nz^2 plus one (nz,nz)
    factorization per subproblem."""
    m_qp = me + mi + nz
    inner = admm_iters * (4.0 * m_qp * nz + 2.0 * nz * nz)
    factor = (2.0 / 3.0) * nz**3 + 2.0 * m_qp * nz * nz  # chol + A'RA
    jac = 2.0 * nz * (me + mi) * 3.0
    return inner + factor + jac


# ---------------------------------------------------------------------------
# Device-memory traffic (bytes) models, the second axis of the bound.
#
# Counting rule: bytes of the batched (B, n)/(B, m) arrays that cross the
# device-memory boundary at kernel boundaries, per instance per iteration,
# float32 by default.  Elementwise chains are taken as fused into the
# product that produces them; every product boundary writes its output.
# The shared (n,n)/(m,n) matrices are read once a launch and amortized over
# the batch (under 1% per instance at B=16384), so they are left out.  The
# models are therefore lower bounds on the true traffic.
# ---------------------------------------------------------------------------


def admm_xla_iter_bytes(n: int, m: int, x_refine: bool = True,
                        itemsize: int = 4) -> float:
    """Bytes of one ADMM iteration for one instance on the unfused path
    (one kernel an operation, ``admm_fused.plain_iterations``).

    rhs build reads z,y,x,q writes rhs (2m+3n+n); x-update reads rhs writes
    xt (2n); zt=xt@A' reads xt writes zt (n+m); z/y/x epilogue reads
    zt,z,y,l,u,xt,x writes x,z,y (5m+2n + n+2m).  Refinement adds xt@M and
    the correction product (reads 3n, writes 2n).
    """
    floats = 10.0 * m + 14.0 * n
    if x_refine:
        floats += 5.0 * n
    return itemsize * floats


def admm_pallas_block_bytes(n: int, m: int, itemsize: int = 4) -> float:
    """Bytes of one fused iteration block for one instance: a launch of K1
    (``ops/admm_fused.py::fused_iterations``).

    The kernel keeps each instance's iterates on chip for all
    ``check_termination`` iterations of the block: it reads
    (x,z,y,done,q,l,u) and writes (x,z,y) once a block, so the iterations'
    own traffic is amortized over the whole block.  (The name is the JAX
    package's, whose counterpart is its Pallas kernel.)
    """
    reads = 2.0 * n + 4.0 * m + 1.0
    writes = n + 2.0 * m
    return itemsize * (reads + writes)


def admm_check_bytes(n: int, m: int, itemsize: int = 4) -> float:
    """Bytes of one termination check for one instance.

    Three matvecs write Ax, Px, A'y (reads 2n+m, writes 2n+m); the
    residual and certificate pass reads Ax,z,Px,q,A'y,l,u,x,y,x_prev,y_prev
    and the infeasibility matvecs add Adx/A'dy/Pdx traffic: ~12m + 10n
    reads and ~4m + 5n writes.
    """
    return itemsize * (16.0 * m + 15.0 * n)


def admm_solve_bytes(n: int, m: int, iters: float, check_every: int,
                     use_pallas: bool = True, x_refine: bool = True) -> float:
    """Bytes of one ADMM solve at a measured iteration count, through K1
    blocks (``use_pallas``, the name of the solver's switch) or the unfused
    iterations."""
    checks = max(iters / max(check_every, 1), 1.0)
    if use_pallas:
        # one block's traffic per check window, independent of how many
        # iterations the window ran (the iterates stay on chip)
        iter_bytes = checks * admm_pallas_block_bytes(n, m)
    else:
        iter_bytes = iters * admm_xla_iter_bytes(n, m, x_refine)
    return iter_bytes + checks * admm_check_bytes(n, m)
