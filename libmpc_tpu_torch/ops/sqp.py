"""Batched SQP solver for the nonlinear MPC problem.

Port of ``libmpc_tpu/ops/sqp.py``: the replacement for NLopt's LD_SLSQP
driving the reference's NLMPC (reference:
include/mpc/NLMPC/NLOptimizer.hpp:64, :519).  Same solver family — sequential
quadratic programming with an l1-merit line search:

* gradients and constraint Jacobians are exact autodiff (``torch.func``; the
  reference uses finite differences, Constraints.hpp:844-905);
* curvature is the exact Lagrangian Hessian convexified by a Gershgorin
  shift by default; eigenvalue clipping (``"eigh"``), a power-iteration shift
  (``"power"``), a constant objective-Hessian model (``"gauss_newton"``) and
  damped BFGS (``"bfgs"``, SLSQP's own family) are selectable;
* the inner QP is the fused whole-solve ADMM kernel
  (``ops/qp_inner_fused.py``, float32), the banded-KKT interior point
  (``ops/trajectory_kkt.py``, for NLPs whose stage-local structure the
  controller verified), the dense interior-point method (``ops/pdip.py``)
  or the per-instance ADMM (``ops/admm.py::admm_solve_each``);
* the line search is a lazy backtracking loop trying [unit step,
  second-order-correction candidate, halvings] and stopping at the first
  Armijo pass.

The JAX package writes the solver for one instance and batches it with
``vmap`` over ``while_loop``s, in which a lane whose own loop condition is
false is frozen.  ``torch.vmap`` cannot batch a data-dependent loop, so this
port is written **batch-first with explicit masks** and driven from the
host: the user functions are per-instance and are batched with
``torch.func.vmap``; every loop (SQP iterations, line-search trials) is a
Python loop that updates only the lanes whose own condition holds and reads
one flag from the device per pass to decide whether any lane is left.  The
per-lane iteration sequence is the JAX package's.

Status codes mirror nlopt's enum values so ``Result.solver_status`` matches
the reference's (reference: include/mpc/NLMPC/NLOptimizer.hpp:729-750).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Sequence

import torch
from torch.func import grad_and_value, hessian, jacfwd, vmap

from ..types import LParameters, NLParameters
from . import _host, admm, batched_linalg, pdip, qp_inner_fused, trajectory_kkt
from .pdip import _mv, _vm

# -- nlopt result values (nlopt.hpp) ----------------------------------------
NLOPT_FAILURE = -1
NLOPT_ROUNDOFF_LIMITED = -4
NLOPT_SUCCESS = 1
NLOPT_STOPVAL_REACHED = 2
NLOPT_FTOL_REACHED = 3
NLOPT_XTOL_REACHED = 4
NLOPT_MAXEVAL_REACHED = 5
NLOPT_MAXTIME_REACHED = 6

_LS_STEPS = 12  # step ladder 2^0 .. 2^-11 (+1 SOC candidate)
_INTERNAL_ACC = 1e-7  # optimality tolerance when no user tol is set
_MAX_LS_FAILS = 4
_MAX_STALL = 6
_ARMIJO_C1 = 1e-4
# The second-order correction solves its me x me system exactly up to this
# size and by 16 steps of CG above it.  The number is the JAX package's (its
# Pallas Cholesky kernel's VMEM gate, 6 k^2 128 4 <= 8 MiB), kept as a
# constant of the algorithm: which solve a lane gets decides its trial step,
# and must not depend on what this port's CUDA kernel can take.
_SOC_EXACT_MAX = 52

# The fused engine's size gate, the JAX package's: its Pallas kernel's VMEM
# footprint of one 128-lane tile (``libmpc_tpu/ops/qp_inner_pallas.py:35-67``:
# inputs and outputs double-buffered, the factorization scratch once) must
# stay under 8 MiB.  Kept as a constant of the algorithm, like
# ``_SOC_EXACT_MAX``: which engine serves a request decides its answer, and
# must not depend on what this port's CUDA kernel can take.
_FUSED_TILE_B = 128
_FUSED_BUDGET_BYTES = 8 * 1024 * 1024


def _fused_tile_bytes(n: int, m: int) -> int:
    words_in = n * n + m * n + 3 * n + 5 * m + 1
    words_out = n + 2 * m + 4
    words_scratch = 3 * n * n + n + 3 * m + 1
    return 4 * _FUSED_TILE_B * (2 * (words_in + words_out) + words_scratch)


def _fused_size_ok(n: int, m: int) -> bool:
    """Whether the JAX package would run an (n, m) subproblem on its fused
    engine (``qp_inner_pallas.supported``)."""
    return _fused_tile_bytes(n, m) < _FUSED_BUDGET_BYTES


_HESSIAN_MODES = ("gershgorin", "eigh", "power", "gauss_newton", "bfgs")

# The SQP loop's evaluations of the NLP (each derivative block and each merit
# evaluation of a trial or of the second-order correction) and those a CUDA
# graph's replay served (:class:`_EvalGraph`), since each was last set to 0.
# Kept on every device, as ``_host.reads``; nothing in the solver reads them.
evals = 0
replays = 0

_capture_streams: dict = {}  # device -> the stream the evaluations capture on
# (device, evaluation) -> the graph of that evaluation's last capture, never
# replayed again: the next capture allocates from its memory pool, so that a
# call's graph memory passes to the next call instead of piling up (a pool
# whose graph has died is freed only by ``torch.cuda.empty_cache``)
_last_capture: dict = {}


class _EvalGraph:
    """One of the SQP loop's evaluations of the NLP within one
    :func:`sqp_solve` call, ``fn(*inputs)`` returning a tuple of tensors,
    replayed as a CUDA graph where :func:`admm._use_graphs` says (the card;
    the CPU runs it eagerly).

    The evaluations of the call's first SQP iteration run eagerly: they are
    the warm-up, and a call of one iteration captures nothing.  Once
    :attr:`armed` (from the second iteration on), the next evaluation
    captures ``fn`` on the graph's own copies of its inputs and replays it,
    and every later one copies its inputs in and replays.  What ``fn`` closes
    over (the solve's ``fn_args``) is fixed for the call and captured as it
    is.  A replay launches the eager evaluation's kernels on the same shapes
    and writes the same output tensors each time, so an output kept past the
    next evaluation has to be copied first.  Where the capture raises
    (``fn`` reads from the device or copies from the host, which a graph
    cannot hold), the evaluation stays eager for the rest of the call.  A
    graph is replayed only by the call that captured it: the controllers
    build their functions anew for every solve.  ``kind`` names the
    evaluation; each kind's captures on a device share one memory pool, and
    two kinds never share one, since the outputs of one are read after the
    other replays."""

    def __init__(self, kind, fn, device):
        self.kind, self.fn = kind, fn
        self.capturable = admm._use_graphs(device)
        self.armed = False
        self.graph = None

    def __call__(self, *inputs):
        global evals, replays
        evals += 1
        if self.graph is None and self.capturable and self.armed:
            self.capturable = self.capture(inputs)
        if self.graph is None:
            return self.fn(*inputs)
        for buf, val in zip(self.inputs, inputs):
            buf.copy_(val)
        replays += 1
        return self.replay()

    def capture(self, inputs) -> bool:
        """Capture ``fn`` on new tensors shaped as ``inputs`` (sets
        :attr:`graph`, :attr:`inputs` and :attr:`outputs`); False, with
        nothing kept, where the capture raises."""
        dev = inputs[0].device
        side = _capture_streams.get(dev)
        if side is None:
            side = _capture_streams[dev] = torch.cuda.Stream(dev)
        self.inputs = tuple(torch.empty_like(t) for t in inputs)
        graph = torch.cuda.CUDAGraph()
        last = _last_capture.get((dev, self.kind))
        side.wait_stream(torch.cuda.current_stream(dev))
        # capture_begin/end, not torch.cuda.graph, which synchronizes and
        # empties the allocator's cache at every capture
        try:
            with torch.cuda.stream(side):
                graph.capture_begin(*(() if last is None else (last.pool(),)))
                try:
                    outputs = self.fn(*self.inputs)
                finally:
                    graph.capture_end()
        except RuntimeError:
            self.inputs = None
            return False
        self.graph, self.outputs = graph, outputs
        _last_capture[(dev, self.kind)] = graph
        return True

    def replay(self):
        self.graph.replay()
        return self.outputs


class Carry(NamedTuple):
    """SQP loop state, batch axis leading — module-scope so resumable chunks
    (begin / chunk / finish) share one record type."""

    z: torch.Tensor
    lam_e: torch.Tensor
    lam_i: torch.Tensor
    f: torch.Tensor
    mu_e: torch.Tensor
    mu_i: torch.Tensor
    it: torch.Tensor
    status: torch.Tensor
    ls_fails: torch.Tensor
    viol: torch.Tensor
    qp_x: torch.Tensor  # inner-QP warm start: previous direction
    qp_y: torch.Tensor  # inner-QP warm start: previous duals
    f_best: torch.Tensor  # stagnation tracking: best objective seen
    viol_best: torch.Tensor  # stagnation tracking: best violation seen
    stall: torch.Tensor  # iterations without meaningful progress
    # quasi-Newton state ("bfgs" mode; inert under exact-Hessian modes)
    Bmat: torch.Tensor  # (B, nz, nz) PSD curvature model
    z_prev: torch.Tensor  # iterate the stored derivatives belong to
    g_prev: torch.Tensor  # objective gradient at z_prev
    Je_prev: torch.Tensor  # equality Jacobian at z_prev
    Ji_prev: torch.Tensor  # inequality Jacobian at z_prev
    have_prev: torch.Tensor  # bool: the *_prev derivatives are valid
    have_scaled: torch.Tensor  # bool: Shanno-Phua sizing already applied


class SQPSolution(NamedTuple):
    z: torch.Tensor  # (B, nz) final decision vector
    obj: torch.Tensor  # (B,) objective value
    status: torch.Tensor  # (B,) int32 nlopt-style code
    iters: torch.Tensor  # (B,) int32 SQP iterations
    kkt_res: torch.Tensor  # (B,) final constraint violation (inf-norm)


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _amax_abs(v):
    return torch.amax(torch.abs(v), dim=-1)


def _sel(mask, new, old):
    """``new`` on the lanes of ``mask`` (B,), ``old`` elsewhere."""
    return torch.where(mask.reshape(mask.shape + (1,) * (new.dim() - 1)), new, old)


def _gershgorin_convexify(H):
    """PSD shift by a Gershgorin bound: tau >= -lambda_min guarantees
    positive semidefiniteness without an eigendecomposition; more
    conservative than eigenvalue clipping when H is indefinite."""
    nz = H.shape[-1]
    diag = torch.diagonal(H, dim1=-2, dim2=-1)
    radius = torch.sum(torch.abs(H), dim=-1) - torch.abs(diag)
    gersh_lo = torch.amin(diag - radius, dim=-1)
    scale = torch.amax(diag + radius, dim=-1)
    tau = torch.clamp(-gersh_lo, min=0.0) + torch.clamp(1e-6 * scale, min=1e-8)
    return H + tau[:, None, None] * torch.eye(nz, dtype=H.dtype, device=H.device)


def _power_convexify(H):
    """Shift by a *tight* estimate of -lambda_min obtained with two short
    power iterations (pure batched matvecs, no factorization).  Near a
    solution H is PSD, the shift collapses to the floor and the steps match
    the exact-Newton ones."""
    nz = H.shape[-1]
    kw = dict(dtype=H.dtype, device=H.device)
    eye = torch.eye(nz, **kw)
    v0 = (torch.ones((nz,), **kw) + torch.arange(nz, **kw) / nz).expand(H.shape[0], nz)

    def pow_iter(M, v, steps=12):
        for _ in range(steps):
            w = _mv(M, v)
            v = w / torch.clamp(torch.linalg.vector_norm(w, dim=-1, keepdim=True), min=1e-30)
        return _dot(v, _mv(M, v))

    lam_hi = torch.abs(pow_iter(H, v0)) * 1.01 + 1e-8
    # lambda_min(H) = lam_hi - lambda_max(lam_hi*I - H)
    lam_min = lam_hi - pow_iter(lam_hi[:, None, None] * eye - H, v0)
    scale = torch.clamp(lam_hi, min=1e-8)
    tau = torch.clamp(-lam_min, min=0.0) * 1.2 + torch.clamp(1e-6 * scale, min=1e-8)
    return H + tau[:, None, None] * eye


def _eigh_convexify(H):
    """Clip eigenvalues to a 1e-6-relative floor: the tightest convex model
    of H (an eigendecomposition per iteration: one K6 launch on the card,
    ``torch.linalg.eigh`` on the CPU; ``batched_linalg.eig_clip``)."""
    return batched_linalg.eig_clip(H)


def _qp_params(f32: bool = False) -> LParameters:
    """Inner-QP settings: tight tolerances, polish for exact active sets.
    float32 runs get reachable tolerances (1e-9 is below the f32 noise
    floor and would force every subproblem to max-iter)."""
    if f32:
        return LParameters(
            maximum_iteration=500,
            enable_warm_start=True,
            eps_abs=5e-6,
            eps_rel=5e-6,
            eps_prim_inf=1e-5,
            eps_dual_inf=1e-5,
            polish=True,
            adaptive_rho=True,
            check_termination=25,
            scaling_iters=10,
            rho=0.1,
            use_pallas=False,
        )
    return LParameters(
        maximum_iteration=1000,
        enable_warm_start=True,
        eps_abs=1e-9,
        eps_rel=1e-9,
        eps_prim_inf=1e-6,
        eps_dual_inf=1e-6,
        polish=True,
        adaptive_rho=True,
        check_termination=25,
        scaling_iters=10,  # subproblem Hessians can be badly scaled
        rho=0.1,
        use_pallas=False,  # inner QPs are per instance and tiny
    )


def plan_applies(traj_plan, params: NLParameters, nz: int, me: int, mi: int) -> bool:
    """Whether the banded-KKT engine may serve this solve: the controller
    verified the structure, the curvature mode preserves it (``eigh`` fills
    in, ``bfgs`` is dense by construction) and the shapes match the plan."""
    return (
        traj_plan is not None
        and params.hessian_reg in ("gauss_newton", "gershgorin", "power")
        and me == traj_plan.ph * traj_plan.nx
        and mi == traj_plan.mi
        and nz == traj_plan.nz
    )


def inner_engine(params: NLParameters, dtype: torch.dtype, nz: int, m_qp: int,
                 plan_ok: bool = False) -> str:
    """The inner-QP engine a solve runs: ``"fused"``, ``"riccati"``,
    ``"pdip"`` or ``"admm"``.

    Routing of ``libmpc_tpu/ops/sqp.py:218-263``, the card in the TPU's
    place.  ``plan_ok`` says that the controller verified the NLP's banded
    structure, the curvature mode keeps it and the shapes match the plan.
    An ``"admm"`` request runs the per-instance ADMM
    (``admm.admm_solve_each``).  A float32 ``"fused"`` request runs the
    fused kernel where the JAX package's size gate (:func:`_fused_size_ok`)
    admits (nz, m_qp).  With a plan an explicit ``"riccati"`` request runs
    the banded-KKT interior point, and so does a ``"fused"`` request the
    fused engine does not serve (float64, or past that gate).  Without a
    plan ``"riccati"`` degrades to ``"pdip"``, a float64 ``"fused"``
    request runs ``"pdip"`` (an f32 inner direction cannot drive the outer
    loop to 1e-7 stationarity), and a float32 ``"fused"`` request past the
    gate runs ``"admm"``.  A shape the gate admits but the CUDA kernel's
    shared memory does not (``qp_inner_fused.supported``) raises: no
    request quietly becomes another engine than the JAX package's.  The
    gate is the stricter of the two at every shape so far.
    """
    if params.inner_qp not in ("fused", "pdip", "riccati", "admm"):
        raise ValueError(f"unknown inner_qp {params.inner_qp!r}")
    if params.inner_qp == "admm":
        return "admm"
    f32 = dtype == torch.float32
    fused_req = params.inner_qp == "fused"
    use_fused = fused_req and f32 and _fused_size_ok(nz, m_qp)
    if use_fused and not qp_inner_fused.supported(nz, m_qp, dtype):
        raise NotImplementedError(
            f"inner_qp='fused': a subproblem of n={nz}, m={m_qp} is within the "
            "JAX package's fused size gate but past the CUDA kernel's "
            "shared-memory gate (qp_inner_fused.supported)")
    if plan_ok and (params.inner_qp == "riccati" or (fused_req and not use_fused)):
        return "riccati"
    if params.inner_qp in ("pdip", "riccati") or (fused_req and not f32):
        return "pdip"
    if use_fused:
        return "fused"
    # float32, past the gate, no plan: one KKT inverse a lane per SQP
    # iteration instead of one per interior-point iteration
    return "admm"


def sqp_solve(
    f_fn: Callable,  # f_fn(z, *args) -> scalar objective (one instance)
    ceq_fn: Callable,  # ceq_fn(z, *args) -> (me,) equality residuals (== 0)
    cin_fn: Optional[Callable],  # cin_fn(z, *args) -> (mi,) inequalities (<= 0)
    z0: torch.Tensor,  # (B, nz)
    lb: torch.Tensor,  # (nz,) or (B, nz)
    ub: torch.Tensor,
    params: NLParameters,
    iter_budget: Optional[int] = None,
    carry_in: Optional[Carry] = None,
    it_hi: Optional[int] = None,
    return_carry: bool = False,
    fn_args: Sequence = (),
    fn_in_dims: Sequence = (),
    traj_plan: Optional[trajectory_kkt.TrajPlan] = None,
):
    """Solve  min f(z)  s.t.  ceq(z)=0, cin(z)<=0, lb<=z<=ub  from z0, for a
    batch of instances.

    The callables are written for ONE instance (1-D ``z``) and take the
    per-solve data as extra arguments ``fn_args`` (the initial state, the
    runtime parameters); ``fn_in_dims`` says which of them carry the batch
    axis (0) and which are shared (None), as ``torch.func.vmap`` reads it.

    ``iter_budget`` is an SQP-iteration cap implementing the ``time_limit``
    contract (reference: NLMPC sets nlopt maxtime, NLMPC.hpp via
    Types.hpp:108-110); lanes stopped by it report ``NLOPT_MAXTIME_REACHED``
    (NLOptimizer.hpp:744-746).

    Resumable execution (used by the controller-level straggler
    compaction): ``carry_in`` continues a previous partial run instead of
    initializing from ``z0`` (``z0`` still anchors the Gauss-Newton
    curvature); ``it_hi`` pauses the loop once a lane's ``it`` reaches it
    (the iterate is NOT finalized, statuses stay 0 for unconverged lanes);
    ``return_carry=True`` returns the raw :class:`Carry` for a later resume
    instead of an :class:`SQPSolution`.  Chunking the loop this way
    partitions the exact same per-lane iteration sequence.

    ``traj_plan`` is the controller's verified description of the NLP's
    stage-local structure (``trajectory_kkt.make_plan``), or None; with it
    the banded-KKT engine is available (see :func:`inner_engine`).

    Runs with TF32 off — the Hopper form of the JAX package's ``highest``
    matmul precision: a product that keeps three digits cannot drive an
    optimizer to 1e-7 stationarity.
    """
    admm.full_precision(z0.device)
    if params.hessian_reg not in _HESSIAN_MODES:
        raise ValueError(f"unknown hessian_reg {params.hessian_reg!r}")
    Bt, nz = z0.shape
    dtype, dev = z0.dtype, z0.device
    kw = dict(dtype=dtype, device=dev)
    in_dims = (0,) + tuple(fn_in_dims)
    args = tuple(fn_args)

    v_f = vmap(f_fn, in_dims=in_dims)
    v_ceq = vmap(ceq_fn, in_dims=in_dims)
    v_cin = vmap(cin_fn, in_dims=in_dims) if cin_fn is not None else None
    v_grad_f = vmap(grad_and_value(f_fn), in_dims=in_dims)
    v_jac_eq = vmap(jacfwd(ceq_fn), in_dims=in_dims)
    v_jac_in = vmap(jacfwd(cin_fn), in_dims=in_dims) if cin_fn is not None else None

    def merit_terms(z):
        ci = v_cin(z, *args) if v_cin is not None else torch.zeros((Bt, 0), **kw)
        return v_f(z, *args), v_ceq(z, *args), ci

    # the loop's merit evaluations (the trials and the second-order
    # correction) replay on the card; the entry point's is eager
    merit = _EvalGraph("merit", merit_terms, dev)
    f0, ce0, ci0 = merit_terms(z0) if carry_in is None else (None, None, None)
    probe = (ce0, ci0) if carry_in is None else (carry_in.lam_e, carry_in.lam_i)
    me, mi = probe[0].shape[1], probe[1].shape[1]
    m_qp = me + mi + nz

    use_bfgs = params.hessian_reg == "bfgs"
    use_gn = params.hessian_reg == "gauss_newton"
    if not (use_bfgs or use_gn):
        def lagrangian(z, lam_e, lam_i, *a):
            L = f_fn(z, *a) + torch.dot(lam_e, ceq_fn(z, *a))
            if cin_fn is not None:
                L = L + torch.dot(lam_i, cin_fn(z, *a))
            return L

        v_hess_L = vmap(hessian(lagrangian), in_dims=(0, 0, 0) + tuple(fn_in_dims))

    def derivative_terms(z, lam_e, lam_i):
        """(g, f, ce, Je, ci, Ji) at ``z``, and in the exact-Hessian modes the
        Lagrangian's Hessian at (z, lam_e, lam_i), symmetrized."""
        g, f = v_grad_f(z, *args)
        ce = v_ceq(z, *args)
        Je = v_jac_eq(z, *args)
        if v_cin is not None:
            ci = v_cin(z, *args)
            Ji = v_jac_in(z, *args)
        else:
            ci = torch.zeros((Bt, 0), **kw)
            Ji = torch.zeros((Bt, 0, nz), **kw)
        if use_bfgs or use_gn:
            return g, f, ce, Je, ci, Ji
        H = v_hess_L(z, lam_e, lam_i, *args)
        return g, f, ce, Je, ci, Ji, 0.5 * (H + H.transpose(1, 2))

    derivatives = _EvalGraph("derivatives", derivative_terms, dev)

    f32 = dtype == torch.float32
    engine = inner_engine(params, dtype, nz, m_qp,
                          plan_applies(traj_plan, params, nz, me, mi))
    qp_par = _qp_params(f32)
    acc = 1e-5 if f32 else _INTERNAL_ACC
    sqrt_acc = math.sqrt(acc)
    eq_mask = torch.arange(m_qp, device=dev) < me
    big = 1e20
    finite_lb = torch.clamp(lb, min=-big)
    finite_ub = torch.clamp(ub, max=big)
    eye_z = torch.eye(nz, **kw)

    def qp_rows(Je, Ji, ce, ci, z):
        """Constraint rows and bounds of the ADMM engines' subproblem:
        Je d = -ce, Ji d <= -ci, lb - z <= d <= ub - z."""
        A_qp = torch.cat([Je, Ji, eye_z.expand(Bt, nz, nz)], dim=1)
        l_qp = torch.cat(
            [-ce, torch.full((Bt, mi), -float("inf"), **kw), finite_lb - z], dim=1)
        u_qp = torch.cat([-ce, -ci, finite_ub - z], dim=1)
        return A_qp, l_qp, u_qp

    def constraint_viol(ce, ci):
        return torch.amax(
            torch.cat([torch.abs(ce), torch.clamp(ci, min=0.0),
                       torch.zeros((ce.shape[0], 1), **kw)], dim=1), dim=1)

    if carry_in is not None:
        s = Carry(*carry_in)  # resume a previous partial run
    else:
        viol0 = constraint_viol(ce0, ci0)
        zi = lambda: torch.zeros((Bt,), dtype=torch.int32, device=dev)
        zb = lambda: torch.zeros((Bt,), dtype=torch.bool, device=dev)
        s = Carry(
            z=z0,
            lam_e=torch.zeros((Bt, me), **kw),
            lam_i=torch.zeros((Bt, mi), **kw),
            f=f0,
            mu_e=torch.ones((Bt, me), **kw),
            mu_i=torch.ones((Bt, mi), **kw),
            it=zi(),
            status=zi(),
            ls_fails=zi(),
            viol=viol0,
            qp_x=torch.zeros((Bt, nz), **kw),
            qp_y=torch.zeros((Bt, m_qp), **kw),
            f_best=f0,
            viol_best=viol0,
            stall=zi(),
            Bmat=eye_z.expand(Bt, nz, nz),
            z_prev=z0,
            g_prev=torch.zeros((Bt, nz), **kw),
            Je_prev=torch.zeros((Bt, me, nz), **kw),
            Ji_prev=torch.zeros((Bt, mi, nz), **kw),
            have_prev=zb(),
            have_scaled=zb(),
        )

    if use_gn:
        # Gauss-Newton curvature: the OBJECTIVE Hessian only, constraint
        # curvature dropped — the classic real-time-iteration model for MPC.
        # For quadratic costs this matrix is CONSTANT, so it is evaluated
        # once per solve at the entry iterate and reused by every SQP
        # iteration.  Anchored at ``z0`` (not the resume carry) so chunked
        # execution (begin/chunk/finish share one z0) reuses the identical
        # curvature and preserves the per-lane iteration sequence.
        Hf = vmap(hessian(f_fn), in_dims=in_dims)(z0, *args)
        B_gn = _gershgorin_convexify(0.5 * (Hf + Hf.transpose(1, 2)))
        # banded engine: the stage-block extraction of the CONSTANT curvature
        # matrix is done here, once per solve, not in every SQP iteration
        gn_blocks = (trajectory_kkt._h_blocks(traj_plan, B_gn)
                     if engine == "riccati" else None)

    def body(s: Carry, active) -> Carry:
        # A replay's outputs stay valid until the next evaluation of the same
        # kind; everything this iteration returns reaches the carry through
        # the loop's select, a copy, so nothing of them outlives it.
        with _host.span("libmpc.sqp.derivatives"):
            terms = derivatives(s.z, s.lam_e, s.lam_i)
            g, f, ce, Je, ci, Ji = terms[:6]

            ok_upd = None
            if use_bfgs:
                # -- damped BFGS curvature model (Powell's rule) ----------------
                # y uses multipliers fixed at the *current* estimate:
                # y = grad_z L(z, lam) - grad_z L(z_prev, lam), both sides
                # contracted with the same lam
                gL = g + _vm(s.lam_e, Je) + (_vm(s.lam_i, Ji) if mi else 0.0)
                gL_old = (s.g_prev + _vm(s.lam_e, s.Je_prev)
                          + (_vm(s.lam_i, s.Ji_prev) if mi else 0.0))
                sv = s.z - s.z_prev
                y = gL - gL_old
                # Shanno-Phua sizing on the first curvature pair: replace the
                # unit initialization with gamma*I, gamma = y'y/s'y, so the
                # model starts at the right scale
                sy = _dot(sv, y)
                gamma = torch.clamp(_dot(y, y) / torch.where(sy <= 0.0, 1.0, sy), 1e-3, 1e6)
                first_pair = ~s.have_scaled & (sy > 0.0)
                Bbase = _sel(first_pair, gamma[:, None, None] * eye_z, s.Bmat)
                Bs = _mv(Bbase, sv)
                sBs = _dot(sv, Bs)
                theta = torch.where(
                    sy >= 0.2 * sBs, 1.0,
                    0.8 * sBs / torch.where(sBs - sy == 0.0, 1.0, sBs - sy))[:, None]
                yd = theta * y + (1.0 - theta) * Bs
                syd = _dot(sv, yd)
                ok_upd = (s.have_prev & (sBs > 1e-12) & (syd > 1e-12)
                          & (_amax_abs(sv) > 0.0))
                outer = lambda a: a[:, :, None] * a[:, None, :]
                B_upd = (Bbase
                         - outer(Bs) / torch.where(sBs == 0.0, 1.0, sBs)[:, None, None]
                         + outer(yd) / torch.where(syd == 0.0, 1.0, syd)[:, None, None])
                Bm = _sel(ok_upd, B_upd, s.Bmat)
            elif use_gn:
                Bm = B_gn  # constant objective-curvature model (see above)
            else:
                # -- convexified exact Hessian ----------------------------------
                H = terms[6]
                with _host.span("libmpc.sqp.convexify"):
                    if params.hessian_reg == "gershgorin":
                        Bm = _gershgorin_convexify(H)
                    elif params.hessian_reg == "power":
                        Bm = _power_convexify(H)
                    else:
                        Bm = _eigh_convexify(H)

        # -- QP subproblem:  min 1/2 d'Bd + g'd
        #    s.t. Je d = -ce ; Ji d <= -ci ; lb-z <= d <= ub-z ---------------
        finite = lambda v: torch.all(torch.isfinite(v), dim=-1)
        with _host.span("libmpc.sqp.inner_qp"):
            if engine == "riccati":
                # banded-KKT interior point: the same elastic-relaxed Mehrotra
                # IPM as the pdip engine (identical to machine precision,
                # tests/test_torch_trajectory_kkt.py), with every Newton system
                # solved by the stage recursion instead of dense inverses.  Box
                # bounds stay implicit (diagonal barrier weights), so no
                # (2nz, nz) identity rows are materialized.
                ci_pos = torch.clamp(ci, min=0.0)
                dual_scale = torch.amax(
                    torch.cat([torch.abs(s.lam_e), torch.abs(s.lam_i), s.mu_e, s.mu_i,
                               torch.ones((Bt, 1), **kw)], dim=1), dim=1)
                rho_q = (1e4 if f32 else 1e8) * dual_scale * (
                    1.0 + torch.sum(torch.abs(ce), dim=1) + torch.sum(ci_pos, dim=1))
                # IPM cap policy: flat ``inner_iters`` (45 when unset); a lane
                # whose previous direction failed the line search gets the deep
                # cap ``inner_iters_recovery``, clamped so that it never
                # de-escalates.  The rollout's compacted rescue
                # (NLParameters.rescue_iters) is the two-phase alternative.
                it_base = params.inner_iters or 45
                it_deep = max(params.inner_iters_recovery or it_base, it_base)
                ipm_cap = torch.where(s.ls_fails > 0, it_deep, it_base).to(torch.int32)
                ip = trajectory_kkt.ipm_solve(
                    traj_plan, Bm, g, Je, ce, Ji, ci, lb - s.z, ub - s.z, rho_q,
                    n_iters=max(it_base, it_deep), lane_cap=ipm_cap,
                    eps=1e-7 if f32 else 1e-10,
                    h_blocks=gn_blocks if use_gn else None,
                    # no dual warm start, as the JAX package: the non-central
                    # start costs SQP iterations (ipm_solve's warm_y hook stays)
                    warm_y=None,
                )
                ip_ok = finite(ip.d) & finite(ip.nu) & finite(ip.lam)
                d = _sel(ip_ok, ip.d, torch.zeros_like(s.z))
                lam_e = _sel(ip_ok, ip.nu, s.lam_e)
                lam_i = _sel(ip_ok, ip.lam, s.lam_i)
                qp_x_new = d
                qp_y_new = s.qp_y
            elif engine == "pdip":
                # interior-point engine: box bounds folded into inequality rows
                # (+-identity), infinite bounds masked out of the barrier.
                #
                # Elastic relaxation (the analog of SLSQP's augmented problem
                # for inconsistent linearizations, Kraft's slsqp.f "relaxed
                # problem with bound on x(n1)"): one extra FREE variable xi
                # retreats every constraint toward its value at d=0, so the
                # subproblem is ALWAYS feasible (d=0, xi=1 satisfies it).  xi is
                # unconstrained with a large QUADRATIC penalty: at the optimum
                # xi = (nu'ce + lam'ci+)/rho_q, so the equality bias vanishes
                # QUADRATICALLY in the constraint violation, preserving the
                # SQP's Newton-rate constraint convergence at no extra rows.
                ci_pos = torch.clamp(ci, min=0.0)
                dual_scale = torch.amax(
                    torch.cat([torch.abs(s.lam_e), torch.abs(s.lam_i), s.mu_e, s.mu_i,
                               torch.ones((Bt, 1), **kw)], dim=1), dim=1)
                rho_q = (1e4 if f32 else 1e8) * dual_scale * (
                    1.0 + torch.sum(torch.abs(ce), dim=1) + torch.sum(ci_pos, dim=1))
                B_aug = torch.zeros((Bt, nz + 1, nz + 1), **kw)
                B_aug[:, :nz, :nz] = Bm
                B_aug[:, nz, nz] = rho_q
                zero_col = torch.zeros((Bt, nz, 1), **kw)
                eye_b = eye_z.expand(Bt, nz, nz)
                g_aug = torch.cat([g, torch.zeros((Bt, 1), **kw)], dim=1)
                Je_aug = torch.cat([Je, -ce[:, :, None]], dim=2)
                Ji_all = torch.cat([
                    torch.cat([Ji, -ci_pos[:, :, None]], dim=2),
                    torch.cat([eye_b, zero_col], dim=2),
                    torch.cat([-eye_b, zero_col], dim=2),
                ], dim=1)
                bi_all = torch.cat([-ci, finite_ub - s.z, s.z - finite_lb], dim=1)
                mask_all = torch.cat([
                    torch.ones((Bt, mi), dtype=torch.bool, device=dev),
                    torch.isfinite(ub).expand(Bt, nz),
                    torch.isfinite(lb).expand(Bt, nz),
                ], dim=1)
                ip = pdip.pdip_solve(
                    B_aug, g_aug, Je_aug, -ce, Ji_all, bi_all, mask_all,
                    n_iters=30, eps=1e-7 if f32 else 1e-10,
                )
                # defensive: a degenerate subproblem must not poison the outer
                # iteration — a zero direction is simply rejected by the line
                # search and the multiplier estimates keep their last values
                ip_ok = finite(ip.d) & finite(ip.nu) & finite(ip.lam)
                d = _sel(ip_ok, ip.d[:, :nz], torch.zeros_like(s.z))
                lam_e = _sel(ip_ok, ip.nu, s.lam_e)
                lam_i = _sel(ip_ok, ip.lam[:, :mi], s.lam_i)
                qp_x_new = d
                qp_y_new = s.qp_y
            elif engine == "fused":
                # fused ADMM: the whole batch of inner QPs solves in one kernel
                # launch (ops/qp_inner_fused.py) — host-side Ruiz, in-kernel
                # Cholesky + iteration loop + adaptive rho
                A_qp, l_qp, u_qp = qp_rows(Je, Ji, ce, ci, s.z)
                loose = (l_qp <= -1e18) & (u_qp >= 1e18)
                rho_v = admm._rho_vec_of(torch.full((), qp_par.rho, **kw), eq_mask, loose)
                x_f, y_f, *_ = qp_inner_fused.solve_batched(
                    Bm, A_qp, g, l_qp, u_qp, rho_v, s.qp_x, s.qp_y,
                    sigma=1e-5,
                    alpha=qp_par.alpha,
                    eps_abs=max(qp_par.eps_abs, 5e-6),
                    eps_rel=max(qp_par.eps_rel, 5e-6),
                    # warm-started SQP subproblems converge in a few check blocks
                    max_iter=min(qp_par.maximum_iteration, 300),
                    check_every=qp_par.check_termination,
                )
                qp_ok = finite(x_f) & finite(y_f)
                d = _sel(qp_ok, x_f, torch.zeros_like(x_f))
                lam_e = _sel(qp_ok, y_f[:, :me], s.lam_e)
                lam_i = _sel(qp_ok, y_f[:, me:me + mi], s.lam_i)
                qp_x_new = d
                qp_y_new = _sel(qp_ok, y_f, s.qp_y)
            else:
                # per-instance ADMM (ops/admm.py::admm_solve_each): each lane's
                # subproblem with its own scaling and KKT inverse, warm-started
                # from the previous SQP iteration's direction and duals — across
                # iterations the QP changes slowly, so the inner ADMM typically
                # converges in a fraction of the cold iterations.  No finiteness
                # select, as in the JAX package.  Only the lanes still iterating
                # are solved: each lane's solve is its own, and the loop's select
                # discards the others' values.
                A_qp, l_qp, u_qp = qp_rows(Je, Ji, ce, ci, s.z)
                idx = _host.nonzero(active)
                part = (lambda t: t) if idx.numel() == Bt else (lambda t: t[idx])
                sol = admm.admm_solve_each(
                    part(Bm), part(A_qp), part(g), part(l_qp), part(u_qp), params=qp_par,
                    eq_mask=eq_mask, warm_x=part(s.qp_x), warm_y=part(s.qp_y))
                put = lambda old, new: old.index_copy(0, idx, new)
                d = put(torch.zeros_like(s.z), sol.x)
                lam_e = put(s.lam_e, sol.y[:, :me])
                lam_i = put(s.lam_i, sol.y[:, me:me + mi])
                qp_x_new = d
                qp_y_new = put(s.qp_y, sol.y)

        # -- penalty update (SLSQP rule: mu = max(|lam|, (mu+|lam|)/2));
        # after a stalled line search, drop the accumulated history and
        # restart from the current multipliers (stale-large penalties are a
        # classic cause of persistent step rejection near active sets) ------
        stalled = (s.ls_fails > 0)[:, None]
        mu_e = torch.where(
            stalled, torch.abs(lam_e) + 1.0,
            torch.maximum(torch.abs(lam_e), 0.5 * (s.mu_e + torch.abs(lam_e))))
        mu_i = torch.where(
            stalled, torch.abs(lam_i) + 1.0,
            torch.maximum(torch.abs(lam_i), 0.5 * (s.mu_i + torch.abs(lam_i))))

        # -- line search over the step ladder + one SOC candidate ------------
        def phi(fv, cev, civ):
            return (fv + torch.sum(mu_e * torch.abs(cev), dim=1)
                    + torch.sum(mu_i * torch.clamp(civ, min=0.0), dim=1))

        viol0 = (torch.sum(mu_e * torch.abs(ce), dim=1)
                 + torch.sum(mu_i * torch.clamp(ci, min=0.0), dim=1))
        phi0 = f + viol0
        D = _dot(g, d) - viol0

        # second-order correction: after a unit step, remove the remaining
        # (curvature-induced) equality residual with a least-norm correction.
        # Computed ONCE per iteration, outside the line-search loop.
        with _host.span("libmpc.sqp.soc"):
            ce_full = merit(s.z + d)[1]
            if me <= _SOC_EXACT_MAX:
                # SPD solve through the batched Cholesky-inverse kernel
                JJt = Je @ Je.transpose(1, 2) + 1e-10 * torch.eye(me, **kw)
                soc_corr = batched_linalg.spd_solve(JJt, ce_full)
            else:
                # me past the exact solve's size: matrix-free CG on Je Je' —
                # two (me, nz) matvecs per iteration, never forms or factors the
                # dense me^2 system.  The SOC is a trial candidate, not the step
                # itself, so a fixed-iteration approximate solve is sufficient;
                # a poor candidate just loses the line search.
                cg_mv = lambda v: _mv(Je, _vm(v, Je)) + 1e-10 * v
                x_cg = torch.zeros_like(ce_full)
                r = p = ce_full
                rs = _dot(r, r)
                for _ in range(16):
                    Ap = cg_mv(p)
                    a_cg = (rs / torch.clamp(_dot(p, Ap), min=1e-30))[:, None]
                    x_cg = x_cg + a_cg * p
                    r = r - a_cg * Ap
                    rs_new = _dot(r, r)
                    p = r + (rs_new / torch.clamp(rs, min=1e-30))[:, None] * p
                    rs = rs_new
                soc_corr = x_cg
            d_soc = d - _vm(soc_corr, Je)

        # -- lazy backtracking line search ------------------------------
        # Candidates in order [alpha=1, SOC, 1/2, 1/4, ..., 2^-(K-2)]; each
        # trial evaluates the merit ONCE and a lane stops at its first
        # Armijo-passing candidate (SOC judged as a unit step).  Every lane
        # still searching is at the same trial, so one host loop with a
        # per-lane ``ls_done`` mask reproduces the per-instance loop.
        with _host.span("libmpc.sqp.line_search"):
            searching = active.clone()
            ls_done = torch.zeros_like(searching)
            z_acc, f_acc, ce_acc, ci_acc = s.z, f, ce, ci
            # start at phi0 so the accumulator only ever holds candidates that
            # strictly improve on the current iterate
            best_phi = phi0
            for t in range(_LS_STEPS + 1):
                alpha = 2.0 ** -max(t - 1, 0)
                cand = s.z + d_soc if t == 1 else s.z + alpha * d
                fc, cec, cic = merit(cand)
                phic = phi(fc, cec, cic)
                # the strict phi0 guard matters when D = g.d - mu.viol0 > 0 (an
                # inexact QP direction at an infeasible iterate): the Armijo
                # threshold then sits ABOVE phi0 and would accept a
                # merit-increasing step
                passed = (phic <= phi0 + _ARMIJO_C1 * alpha * D) & (phic < phi0)
                take = searching & (passed | (phic < best_phi))
                z_acc = _sel(take, cand, z_acc)
                f_acc = _sel(take, fc, f_acc)
                ce_acc = _sel(take, cec, ce_acc)
                ci_acc = _sel(take, cic, ci_acc)
                best_phi = torch.where(searching, torch.minimum(phic, best_phi), best_phi)
                ls_done = ls_done | (searching & passed)
                searching = searching & ~passed
                if t < _LS_STEPS and not _host.flag(searching.any()):
                    break
        decreased = ls_done | (best_phi < phi0)
        z_new = _sel(decreased, z_acc, s.z)
        f_new = torch.where(decreased, f_acc, f)
        ls_fails = torch.where(decreased, 0, s.ls_fails + 1)
        viol_new = torch.where(decreased, constraint_viol(ce_acc, ci_acc), s.viol)
        step_norm = _amax_abs(z_new - s.z)

        # -- convergence tests ------------------------------------------------
        scale = 1.0 + _amax_abs(s.z)
        kkt_ok = (_amax_abs(d) <= acc * scale) & (s.viol <= sqrt_acc)
        df = torch.abs(f_new - f)
        ftol_ok = torch.zeros_like(kkt_ok)
        if params.absolute_ftol > 0:
            ftol_ok = ftol_ok | (df <= params.absolute_ftol)
        if params.relative_ftol > 0:
            ftol_ok = ftol_ok | (df <= params.relative_ftol * torch.abs(f_new))
        xtol_ok = torch.zeros_like(kkt_ok)
        if params.absolute_xtol > 0:
            xtol_ok = xtol_ok | (step_norm <= params.absolute_xtol)
        if params.relative_xtol > 0:
            xtol_ok = xtol_ok | (step_norm <= params.relative_xtol * _amax_abs(z_new))
        near_feas = viol_new <= sqrt_acc
        # stagnation detector: at the working precision's noise floor the
        # merit can bounce by +-eps-level amounts forever (each tiny
        # decrease resets ls_fails, so the consecutive-failure exit never
        # fires); declare roundoff-limited after _MAX_STALL iterations in
        # which neither the objective nor the violation improved by more
        # than a ~30-ulp margin — the analog of SLSQP's acc-based exit
        eps_m = 1.2e-7 if f32 else 2.2e-16
        tol_f = 32.0 * eps_m * (1.0 + torch.abs(s.f_best))
        tol_v = 32.0 * eps_m * (1.0 + torch.abs(s.viol_best))
        improved = (f_new < s.f_best - tol_f) | (viol_new < s.viol_best - tol_v)
        stall = torch.where(improved, 0, s.stall + 1)
        roundoff = (ls_fails >= _MAX_LS_FAILS) | (stall >= _MAX_STALL)

        status = torch.where(
            kkt_ok, NLOPT_SUCCESS,
            torch.where(
                decreased & ftol_ok & near_feas, NLOPT_FTOL_REACHED,
                torch.where(
                    decreased & xtol_ok & near_feas, NLOPT_XTOL_REACHED,
                    torch.where(roundoff, NLOPT_ROUNDOFF_LIMITED, 0)))).to(torch.int32)

        return Carry(
            z=z_new, lam_e=lam_e, lam_i=lam_i, f=f_new, mu_e=mu_e, mu_i=mu_i,
            it=s.it + 1, status=status, ls_fails=ls_fails.to(torch.int32),
            viol=viol_new, qp_x=qp_x_new, qp_y=qp_y_new,
            f_best=torch.minimum(s.f_best, f_new),
            viol_best=torch.minimum(s.viol_best, viol_new),
            stall=stall.to(torch.int32),
            Bmat=Bm if use_bfgs else s.Bmat,
            z_prev=s.z, g_prev=g, Je_prev=Je, Ji_prev=Ji,
            have_prev=torch.ones_like(s.have_prev),
            have_scaled=(s.have_scaled | ok_upd) if use_bfgs else s.have_scaled,
        )

    max_it = params.maximum_iteration
    budget = admm.NO_BUDGET if iter_budget is None else int(iter_budget)
    hi = max_it if it_hi is None else int(it_hi)
    cap = min(max_it, budget, hi)
    while True:
        # a lane iterates while it has no verdict and has iterations left;
        # finished lanes are frozen (their state is carried unchanged), as a
        # batched while_loop freezes the lanes whose condition is false
        with _host.span("libmpc.sqp.loop_test"):
            s_active = (s.status == 0) & (s.it < cap)
            if not _host.flag(s_active.any()):
                break
        with _host.span("libmpc.sqp.iteration"):
            new = body(s, s_active)
            s = Carry(*(_sel(s_active, n, o) for n, o in zip(new, s)))
        derivatives.armed = merit.armed = True  # the first iteration warmed up

    if return_carry:
        return s
    # status still 0 with iterations to spare means the budget (the
    # time_limit contract) stopped the loop, not maximum_iteration
    status = torch.where(
        s.status == 0,
        torch.where(s.it < max_it, NLOPT_MAXTIME_REACHED, NLOPT_MAXEVAL_REACHED),
        s.status,
    )
    # a "roundoff" exit at an already-feasible, stationary-ish point is a
    # successful solve in practice (the step simply could not improve the
    # merit any further) — matching how SLSQP reports small final steps
    status = torch.where(
        (status == NLOPT_ROUNDOFF_LIMITED) & (s.viol <= sqrt_acc),
        NLOPT_XTOL_REACHED, status,
    ).to(torch.int32)
    return SQPSolution(z=s.z, obj=s.f, status=status, iters=s.it, kkt_res=s.viol)
