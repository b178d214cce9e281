"""Fused batched small-QP ADMM solver: the hand-written CUDA kernel and its
twin.

Counterpart of ``libmpc_tpu/ops/qp_inner_pallas.py``.  The SQP inner QP
(``ops/sqp.py``) is a *per-instance* problem: every batch element has its own
Hessian ``P`` (n, n) and constraint matrix ``A`` (m, n), tens of rows and
columns.  :func:`solve_batched` runs the ENTIRE solve of every instance — KKT
assembly ``M = P + sigma I + A' diag(rho) A``, its factorization and
explicit inverse, the ADMM iteration loop with a convergence check on the
unscaled residuals every ``check_every`` iterations, the per-instance freeze
and the per-instance adaptive rho with refactorization:

* on CUDA tensors in one launch of ``csrc/qp_inner.cu`` (float32 or
  float64), which replaces the Pallas kernel ``qp_inner_pallas.py::_kernel``
  (``pallas_call`` at ``qp_inner_pallas.py:362``);
* on CPU tensors in :func:`plain_solve_batched`, the plain PyTorch twin
  (library Cholesky, ``einsum`` products, a host loop over check blocks).

The host side of the solve is the same for both and lives here: per-instance
Ruiz equilibration, scaling of the data and the warm starts, the clamp of
infinite bounds, and the unscaling of the result.

Algorithm (identical to ``ops/admm_fused.py``'s iteration, reference OSQP
v0.6.3 / LOptimizer.hpp): x-update through the explicit KKT inverse with one
refinement pass, over-relaxation ``alpha``, box projection, exact-zero
inactive duals.

What bounds the kernel on an H100, and what its design does about it.  One
instance is about 14 KB of matrices and 1e4 floating-point operations per
iteration; at the SQP's batch the card's memory rate and arithmetic rate
would both be done in tens of microseconds.  The work is ``check_every``
iterations of five small matrix-vector products each, one after the other,
per check block: what costs is how each multiply-add gets its operands and
how long one product's dependent chain is.  One warp owns one instance,
leaves the loop when ITS instance converges and refactorizes only when ITS
rho moves; the TPU kernel's 128-lane tile (which runs until all 128 are
done and refactorizes all of them together) and its edge-replicated padding
have no counterpart — a ragged batch is a bounds check.  The kernel has two
layouts of the same algorithm, chosen by shape at launch (:func:`tier`):

* ``"register"`` (n <= 32, m <= 64; Van der Pol's subproblem is n = 26,
  m = 57): A and M^-1 live in registers as 2-D tiles (16 x 4 of A and 4 x 8
  of M^-1 per lane; M, used once an iteration, as the same tile read from
  shared memory); a product reads its vector from shared memory once per
  lane, does 32-64 independent multiply-adds and sums the lanes' partials
  by a butterfly of 3-14 shuffles, so an iteration issues 26 shared-memory
  loads where the other tier issues 374, and a product's chain is a few
  multiply-adds and shuffle steps, not 26-57 dependent multiply-adds.  M is
  inverted by Gauss-Jordan elimination with one row per lane.  The
  refinement residual ``rhs - M x`` is summed error-free (Dot2): a plain
  float32 sum is mostly the rounding of ``M x``, and the refinement then
  left a sixth of the Van der Pol lanes at the iteration cap.
* ``"shared"`` (every other shape :func:`supported` admits, up to n = 56 or
  m ~ 860): A, M, the factor workspace, M^-1 and every vector stay in shared
  memory with an odd leading dimension, and every multiply-add reads two
  operands from there; measured (``chip_smoke.py --sweep-k3`` when this
  layout served every shape) 675 cycles per iteration per SM at full
  residency, bound by shared-memory load throughput.

What a trace sees.  :func:`solve_batched` opens three spans
(``ops/_host.py::span``, inside the SQP's ``libmpc.sqp.inner_qp``):
``libmpc.qp_fused.scale`` (the host-side Ruiz equilibration and the scaled
data), ``libmpc.qp_fused.iterate`` (the K3 launch on the card, the twin's loop
on the CPU) and ``libmpc.qp_fused.unscale``.  ``solve_batched.trace``, None
unless a reader sets it to a list, receives each solve's per-instance
(iterations, done) tensors.

:func:`supported` is the kernel's own gate: the shared memory of one warp's
instance, in its tier's layout (:func:`smem_bytes`), must fit the 227 KB a
block can use; past it a request raises.
"""

from __future__ import annotations

import torch

from . import _build, _host
from .admm import _ruiz_equilibration

INF_BOUND = 1e18
SMEM_LIMIT_BYTES = 232448  # dynamic shared memory one Hopper block can use
# warps (= instances) per block.  Instances finish at different times, so
# the smallest block schedules best: 1 warp per block measured 0.757-0.769
# ms against 0.789-0.807 (2 warps) and 0.836-0.857 (4, the register tier's
# most) at B=4096 on an H100 (``chip_smoke.py --sweep-k3``)
WARPS_PER_BLOCK = 1
# the register tier's capacities: one column of x-like vectors per lane, two
# constraint rows per lane; past either the shared-memory tier runs.  This
# and :func:`smem_bytes` restate the launcher's layout
# (``csrc/qp_inner.cu::libmpc_qp_inner_layout``) for the gate, which also
# answers on the CPU, where no library is built; a card test holds the two
# equal at every shape up to n = 64, m = 900
REG_MAX_N, REG_MAX_M = 32, 64


def tier(n: int, m: int) -> str:
    """The kernel's layout for an (n, m) subproblem: ``"register"`` or
    ``"shared"`` (a function of the shape alone, never of a failure)."""
    return "register" if n <= REG_MAX_N and m <= REG_MAX_M else "shared"


def smem_bytes(n: int, m: int, dtype: torch.dtype = torch.float32) -> int:
    """Shared memory of one warp (= one instance) in the kernel, by tier.

    Register tier: A (m x 32, zero past n), M and the elimination's
    workspace (32 x 36 each), a two-row pivot buffer (2 x 32), four x-like
    vectors (rhs, x tilde, the refinement residual, the refined x tilde; 32
    each), the row vector rho z - y (64 rows and an 8-word skew), rho and
    einv (64 each).  Shared tier: A (m, ld), M, the factor workspace and
    M^-1 (n, ld each) with the odd leading dimension ``ld = n | 1``, 6
    vectors of n (x, q, rhs, xt, the refinement residual, dinv) and 7 of m
    (z, y, rho, l, u, rho z - y, einv)."""
    if tier(n, m) == "register":
        words = 32 * m + 2 * 32 * 36 + 2 * 32 + 4 * 32 + (64 + 8) + 2 * 64
    else:
        ld = n | 1
        words = m * ld + 3 * n * ld + 6 * n + 7 * m
    return words * torch.finfo(dtype).bits // 8


def supported(n: int, m: int, dtype: torch.dtype = torch.float32) -> bool:
    """Whether the CUDA kernel takes an (n, m) subproblem: one instance must
    fit a block's shared memory in its tier's layout.  A request past the
    gate raises; it is not handed to another engine."""
    return n >= 1 and m >= 1 and smem_bytes(n, m, dtype) <= SMEM_LIMIT_BYTES


def _scale_problem(P, A, q, l, u, x0, y0, ruiz_iters: int):
    """Per-instance Ruiz equilibration and the scaled problem the iteration
    runs on (``qp_inner_pallas.py:300-338``): returns the scaled data, the
    scaled warm starts (xbar = x/d, ybar = c*y/e) and (d, e, c)."""
    B, n = q.shape
    m = A.shape[1]
    kw = dict(dtype=P.dtype, device=P.device)
    if ruiz_iters > 0:
        d, e, c = _ruiz_equilibration(P, A, q, ruiz_iters)
    else:
        d, e, c = torch.ones((B, n), **kw), torch.ones((B, m), **kw), torch.ones((B,), **kw)
    cb = c[:, None]
    Ps = cb[:, :, None] * P * d[:, None, :] * d[:, :, None]
    As = A * e[:, :, None] * d[:, None, :]
    qs = cb * q * d
    # infinite bounds are clamped AFTER scaling, as the TPU wrapper does
    ls = torch.clamp(e * l, min=-INF_BOUND)
    us = torch.clamp(e * u, max=INF_BOUND)
    return Ps, As, qs, ls, us, x0 / d, cb * y0 / e, d, e, c


def _iterate_plain(P, A, q, l, u, rho, x, y, dinv, einv, cinv, *, sigma, alpha,
                   eps_abs, eps_rel, max_iter, check_every, refine):
    """The kernel's body in plain PyTorch on the scaled problem: returns the
    scaled (x, y, z) and (iters, done, pri, dua)."""
    B, n = q.shape
    dtype, dev = q.dtype, q.device
    eye = torch.eye(n, dtype=dtype, device=dev)

    def factorize(rho):
        M = P + sigma * eye + torch.einsum("bri,brj->bij", A * rho[:, :, None], A)
        L, _ = torch.linalg.cholesky_ex(M)
        return M, torch.cholesky_inverse(L)

    rho = rho.clone()
    M, Minv = factorize(rho)
    z = torch.einsum("bmn,bn->bm", A, x)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    iters = torch.zeros(B, dtype=torch.int32, device=dev)
    pri = torch.zeros(B, dtype=dtype, device=dev)
    dua = torch.zeros(B, dtype=dtype, device=dev)
    amax = lambda v: torch.amax(torch.abs(v), dim=-1)
    tiny = 1e-30
    n_blocks = max(1, (max_iter + check_every - 1) // check_every)
    for _ in range(n_blocks):
        frozen = done[:, None]
        for _ in range(check_every):
            rhs = sigma * x - q + torch.einsum("bmn,bm->bn", A, rho * z - y)
            xt = torch.einsum("bij,bj->bi", Minv, rhs)
            if refine:
                resid = rhs - torch.einsum("bij,bj->bi", M, xt)
                xt = xt + torch.einsum("bij,bj->bi", Minv, resid)
            zt = torch.einsum("bmn,bn->bm", A, xt)
            x_new = alpha * xt + (1.0 - alpha) * x
            z_relax = alpha * zt + (1.0 - alpha) * z
            z_unc = z_relax + y / rho
            z_new = torch.clamp(z_unc, min=l, max=u)
            clipped = (z_unc < l) | (z_unc > u)
            y_new = torch.where(clipped, y + rho * (z_relax - z_new), 0.0)
            x = torch.where(frozen, x, x_new)
            z = torch.where(frozen, z, z_new)
            y = torch.where(frozen, y, y_new)
        # convergence check on UNSCALED residuals (OSQP semantics): the
        # iteration runs on the scaled problem, the stopping test multiplies
        # back by D^-1 / E^-1 / c^-1
        Ax = einv * torch.einsum("bmn,bn->bm", A, x)
        Px = dinv * torch.einsum("bij,bj->bi", P, x)
        Aty = dinv * torch.einsum("bmn,bm->bn", A, y)
        pri = amax(Ax - einv * z)
        dua = cinv * amax(Px + dinv * q + Aty)
        pri_rel = torch.maximum(amax(Ax), amax(einv * z))
        dua_rel = cinv * torch.maximum(torch.maximum(amax(Px), amax(Aty)),
                                       amax(dinv * q))
        conv = (pri <= eps_abs + eps_rel * pri_rel) & (dua <= eps_abs + eps_rel * dua_rel)
        # adaptive rho (OSQP 5.2): scale the whole per-row rho vector by
        # sqrt(primal / dual residual ratio) per instance; refactor the
        # instances that move by more than 5x
        ratio = torch.sqrt(
            (pri / torch.clamp(pri_rel, min=tiny))
            / torch.clamp(dua / torch.clamp(dua_rel, min=tiny), min=tiny)
        )
        ratio = torch.clamp(ratio, 1e-4, 1e4)
        adapt = ~done & ~conv & ((ratio > 5.0) | (ratio < 0.2))
        # the counter advances by a whole block up to and including the
        # block in which the instance converges
        iters = torch.where(done, iters, iters + check_every)
        done = done | conv
        if _host.flag(done.all()):
            break
        if _host.flag(adapt.any()):
            scale = torch.where(adapt, ratio, 1.0)[:, None]
            rho = torch.clamp(rho * scale, 1e-6, 1e6)
            M_new, Minv_new = factorize(rho)
            sel = adapt[:, None, None]
            M = torch.where(sel, M_new, M)
            Minv = torch.where(sel, Minv_new, Minv)
    return x, y, z, iters, done, pri, dua


def _iterate_kernel(P, A, q, l, u, rho, x, y, dinv, einv, cinv, *, sigma, alpha,
                    eps_abs, eps_rel, max_iter, check_every, refine):
    """One launch of ``csrc/qp_inner.cu`` for the whole batch (same
    arguments and returns as :func:`_iterate_plain`)."""
    B, n = q.shape
    m = A.shape[1]
    dtype, dev = q.dtype, q.device
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"fused inner-QP kernel takes float32/float64, got {dtype}")
    if not supported(n, m, dtype):
        raise ValueError(
            f"fused inner-QP kernel: n={n}, m={m} needs {smem_bytes(n, m, dtype)} "
            f"bytes of shared memory per instance ({tier(n, m)} tier), over the "
            f"{SMEM_LIMIT_BYTES} a block can use"
        )
    expect = {"P": (P, (B, n, n)), "A": (A, (B, m, n)), "q": (q, (B, n)),
              "l": (l, (B, m)), "u": (u, (B, m)), "rho": (rho, (B, m)),
              "x0": (x, (B, n)), "y0": (y, (B, m)), "dinv": (dinv, (B, n)),
              "einv": (einv, (B, m)), "cinv": (cinv, (B,))}
    args = {}
    for name, (t, shape) in expect.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
        if t.dtype != dtype or t.device != dev:
            raise TypeError(f"{name}: {t.dtype} on {t.device}, expected {dtype} on {dev}")
        args[name] = t.contiguous()
    xo = torch.empty((B, n), dtype=dtype, device=dev)
    yo = torch.empty((B, m), dtype=dtype, device=dev)
    zo = torch.empty((B, m), dtype=dtype, device=dev)
    iters = torch.empty((B,), dtype=torch.int32, device=dev)
    done = torch.empty((B,), dtype=torch.int32, device=dev)
    pri = torch.empty((B,), dtype=dtype, device=dev)
    dua = torch.empty((B,), dtype=dtype, device=dev)
    if B == 0:
        return xo, yo, zo, iters, done.bool(), pri, dua
    lib = _build.library()
    fn = lib.libmpc_qp_inner_f32 if dtype == torch.float32 else lib.libmpc_qp_inner_f64
    n_blocks = max(1, (max_iter + check_every - 1) // check_every)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(
            *(args[k].data_ptr() for k in expect),
            xo.data_ptr(), yo.data_ptr(), zo.data_ptr(), iters.data_ptr(),
            done.data_ptr(), pri.data_ptr(), dua.data_ptr(),
            B, n, m, float(sigma), float(alpha), float(eps_abs), float(eps_rel),
            n_blocks, int(check_every), int(bool(refine)),
            WARPS_PER_BLOCK, stream,
        )
    _build.check(code, "qp_inner kernel launch")
    solve_batched.launches += 1
    return xo, yo, zo, iters, done.bool(), pri, dua


def _solve(iterate, P, A, q, l, u, rho_vec, x0, y0, *, ruiz_iters, **kw):
    dtype = q.dtype
    with _host.span("libmpc.qp_fused.scale"):
        P, A, l, u, rho_vec, x0, y0 = (t.to(dtype) for t in (P, A, l, u, rho_vec, x0, y0))
        Ps, As, qs, ls, us, xs, ys, d, e, c = _scale_problem(P, A, q, l, u, x0, y0,
                                                             ruiz_iters)
        dinv, einv, cinv = 1.0 / d, 1.0 / e, 1.0 / c
    with _host.span("libmpc.qp_fused.iterate"):
        x, y, z, iters, done, pri, dua = iterate(
            Ps, As, qs, ls, us, rho_vec, xs, ys, dinv, einv, cinv, **kw)
    if solve_batched.trace is not None:
        solve_batched.trace.append((iters, done))
    # unscale: x = D xbar, z = E^-1 zbar, y = E ybar / c
    with _host.span("libmpc.qp_fused.unscale"):
        return x * d, y * e * cinv[:, None], z * einv, iters, done, pri, dua


def plain_solve_batched(P, A, q, l, u, rho_vec, x0, y0, *, sigma=1e-5, alpha=1.6,
                        eps_abs=5e-6, eps_rel=5e-6, max_iter=500, check_every=25,
                        refine=True, ruiz_iters=10):
    """:func:`solve_batched` in plain PyTorch (the kernel's twin), on the
    device and in the dtype of its arguments."""
    return _solve(_iterate_plain, P, A, q, l, u, rho_vec, x0, y0,
                  ruiz_iters=ruiz_iters, sigma=sigma, alpha=alpha, eps_abs=eps_abs,
                  eps_rel=eps_rel, max_iter=max_iter, check_every=check_every,
                  refine=refine)


def solve_batched(P, A, q, l, u, rho_vec, x0, y0, *, sigma=1e-5, alpha=1.6,
                  eps_abs=5e-6, eps_rel=5e-6, max_iter=500, check_every=25,
                  refine=True, ruiz_iters=10):
    """Solve a batch of small dense QPs ``min 1/2 x'Px + q'x, l <= Ax <= u``.

    Args (batch axis leading): P (B,n,n), A (B,m,n), q (B,n), l/u/rho_vec
    (B,m), warm starts x0 (B,n), y0 (B,m) — all UNSCALED.  Ruiz
    equilibration runs here (once per problem, batched tensor ops), the
    solver iterates on the scaled problem and applies the stopping test to
    unscaled residuals, and the returned (x, y, z, iters, done, pri, dua)
    are unscaled.  ``rho_vec`` carries the per-row penalty (equality rows
    boosted, loose rows at the minimum — ``ops/admm.py::_rho_vec_of``,
    computed by the caller from masks, which are scale-invariant).

    CPU tensors run the plain twin; CUDA tensors launch the kernel on the
    current stream (one launch for the whole batch, counted in
    ``solve_batched.launches``) or raise.
    """
    kw = dict(ruiz_iters=ruiz_iters, sigma=sigma, alpha=alpha, eps_abs=eps_abs,
              eps_rel=eps_rel, max_iter=max_iter, check_every=check_every,
              refine=refine)
    if q.device.type == "cpu":
        return _solve(_iterate_plain, P, A, q, l, u, rho_vec, x0, y0, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"fused inner-QP kernel: unsupported device {q.device}")
    return _solve(_iterate_kernel, P, A, q, l, u, rho_vec, x0, y0, **kw)


solve_batched.launches = 0
# a measurement script may set this to a list: every solve then appends its
# per-instance (iters, done) tensors; None (the default) records nothing
solve_batched.trace = None
