"""Core public types of the PyTorch port.

Parity surface of ``libmpc_tpu/types.py`` (itself mirroring the reference
library's ``Types.hpp``, include/mpc/Types.hpp:57-206): ``HorizonSlice``,
``ResultStatus``, ``Parameters``/``LParameters``/``NLParameters``,
``Result`` and ``OptSequence``.  Every parameter field name and default is
the JAX package's, including the knobs whose comments describe the TPU
measurements that chose them; ``Result``/``OptSequence`` are plain
dataclasses of tensors whose leaves may carry a leading batch axis.

The working dtype of controllers built without an explicit one comes from
:func:`default_dtype`, a port-level setting (float32 unless
:func:`set_default_dtype` changed it); the JAX package reads
``jax_enable_x64`` instead.
"""

from __future__ import annotations

import dataclasses
import enum

import torch

inf = float("inf")

_default_dtype = torch.float32


def default_dtype() -> torch.dtype:
    """Working dtype of controllers built without an explicit one."""
    return _default_dtype


def set_default_dtype(dtype: torch.dtype) -> None:
    """Set the port-level default working dtype (float32 or float64)."""
    global _default_dtype
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"default dtype must be float32 or float64, got {dtype}")
    _default_dtype = dtype


def default_device() -> torch.device:
    """Device of controllers and records built without an explicit one: the
    CUDA card.  The port runs on the card unless the caller asks for the CPU
    (``device="cpu"``); it never gives way to the CPU on its own."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "libmpc_tpu_torch runs on a CUDA device by default and "
            "torch.cuda.is_available() is False: no CUDA card was found; "
            'pass device="cpu" to run on the CPU'
        )
    return torch.device("cuda")


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; None means :func:`default_device`."""
    return default_device() if device is None else torch.device(device)


@dataclasses.dataclass(frozen=True)
class HorizonSlice:
    """Subset ``[start, end)`` of the horizon (reference: include/mpc/Types.hpp:57-82).

    ``HorizonSlice.all()`` is the (-1, -1) sentinel meaning "the whole horizon".
    """

    start: int
    end: int

    @staticmethod
    def all() -> "HorizonSlice":
        return HorizonSlice(-1, -1)

    @property
    def is_unset(self) -> bool:
        return self.start == -1 and self.end == -1


class ResultStatus(enum.IntEnum):
    """Optimization result status (reference: include/mpc/Types.hpp:87-94)."""

    SUCCESS = 0
    MAX_ITERATION = 1
    INFEASIBLE = 2
    ERROR = 3
    UNKNOWN = 4


class ConstraintsType(enum.IntEnum):
    """Constraint families (reference: include/mpc/Types.hpp:200-206)."""

    INEQ = 0
    EQ = 1
    UINEQ = 2
    UEQ = 3


@dataclasses.dataclass(frozen=True)
class Parameters:
    """Shared optimizer parameters (reference: include/mpc/Types.hpp:99-115).

    ``time_limit`` (seconds, 0 = unlimited) is enforced as a *measured-cost
    iteration budget*: the controller measures its own per-iteration wall
    cost and converts the deadline into an iteration cap
    (see :mod:`libmpc_tpu_torch.utils.deadline`).  Solves stopped by the cap return
    the reference's time-limit statuses (``OSQP_TIME_LIMIT_REACHED`` /
    ``NLOPT_MAXTIME_REACHED``) with the partial iterate.  Enforcement begins
    once a calibration measurement exists (the first post-compilation solve
    runs unlimited).
    """

    maximum_iteration: int = 100
    time_limit: float = 0.0
    enable_warm_start: bool = False


@dataclasses.dataclass(frozen=True)
class LParameters(Parameters):
    """OSQP-style ADMM parameters (reference: include/mpc/Types.hpp:146-161).

    Extra TPU-specific knobs (absent in the reference, defaults keep parity):

    * ``check_termination``: residuals are evaluated every N iterations so the
      hot loop stays pure matmuls (OSQP uses 25 internally as well).
    * ``polish_refine_iter``: iterative-refinement steps of the polish KKT
      solve (OSQP default 3).
    """

    alpha: float = 1.6
    rho: float = 1e-6
    eps_rel: float = 1e-4
    eps_abs: float = 1e-4
    eps_prim_inf: float = 1e-3
    eps_dual_inf: float = 1e-3
    verbose: bool = False
    adaptive_rho: bool = True
    polish: bool = True
    # TPU-native extensions
    check_termination: int = 25
    polish_refine_iter: int = 3
    # polish implementation: "shared" solves each instance's active-set
    # system with one shared factorization + an exact Woodbury correction
    # over its (<= polish_active_cap) active inequality rows — gathers,
    # (k,k) batched Cholesky and shared matmuls only, ~one ADMM block of
    # cost; "dense" does per-instance (n,n) Cholesky factorizations
    # (OSQP-like, ~5x a whole solve at large batch, used automatically on
    # the row-sharded path)
    polish_mode: str = "shared"
    # Woodbury correction width of the shared polish: instances with more
    # active inequality rows than this fall back to the ADMM iterate for
    # the overflow rows.  24 measured accuracy-IDENTICAL to 40 on the full
    # randomized quadrotor bench batch (misc/batch_accuracy.py: cold/warm
    # max errors equal to 3 digits — active sets fit within 24) while the
    # hardware sweep put cap 24 at +24% throughput over cap 40 (246k vs
    # 187k solves/s, misc/results/SWEEP_TPU_r2_batch2.txt).  Raise it for
    # problem families with wider active sets.
    polish_active_cap: int = 24
    # float32 shared-polish refinement budget: number of incremental
    # residual-update passes run after the compensated anchor (each pass
    # contracts the residual ~0.7x below the float32 matvec floor; the
    # default leaves ~13x margin to the 1e-4 golden target on the
    # quadrotor family — lower it to trade accuracy margin for step time)
    polish_comp_passes: int = 8
    # float32 iteration extras: one iterative-refinement pass of every
    # ADMM x-update against the true KKT matrix (recovers the digits the
    # explicit f32 inverse loses, at ~2 extra (n, n) matmuls per
    # iteration — about a quarter of the iteration FLOPs).  With the
    # shared polish repairing final accuracy this is a speed/robustness
    # tradeoff, not an accuracy requirement.
    x_refine: bool = True
    # lockstep batches pay for their slowest instance: once the number of
    # unconverged instances falls to 1/16 of the batch, compact them into
    # a small batch and iterate only that (identical per-row math and
    # check cadence; single-chip batched path, batch >= 256)
    compact_stragglers: bool = True
    # straggler stall detection (TPU-native extension): an instance whose
    # primal AND dual residuals have improved by less than 1% for this many
    # consecutive termination checks, while already passing OSQP's
    # 100x-relaxed final check, freezes immediately with the exact status a
    # maximum_iteration exit would report (OSQP_SOLVED_INACCURATE).  In
    # float32 ~1% of warm closed-loop instances sit at the residual noise
    # floor just above eps and would otherwise burn every remaining
    # iteration without changing their (polish-repaired) answer — measured
    # round 4: same 1.1% of instances still unconverged at a 1000-iteration
    # cap, with matched-state command error 3.8e-5 (misc/diagnose_tail*.py).
    # 0 disables (exact OSQP iteration-for-iteration parity).
    stall_checks: int = 3
    # cold-start initialization (TPU-native extension): "kkt" seeds a solve
    # with no warm start at the minimizer of the rho-weighted equality-
    # anchored quadratic model, x0 = M^-1 (A'R clip(0,l,u) - q) — one extra
    # matmul against the already-prepared KKT inverse; "zeros" (default)
    # starts at the origin like OSQP.  Measured on the quadrotor family
    # (TPU v5e, B=4096 cold batch): the seed INCREASED cold iterations
    # (209.8 vs 195.1 mean) — a good primal with zero duals starts the
    # ADMM off the central path — so the origin stays the default; the
    # option remains for problem families where the equality-anchored
    # seed lands nearer the constrained optimum.  "kkt_duals" (round-5
    # attempt 2, acting on that diagnosis) additionally seeds the duals
    # from the seeded primal's constraint activity,
    # y0 = rho (A x_seed - clip(A x_seed, l, u)) — the dual step ADMM
    # itself would take — so the pair starts consistent; see
    # docs/performance.md for the measured verdict.
    cold_start: str = "zeros"
    # cold-solve rho escalation (TPU-native extension, round-5 cold-start
    # attempt 2c).  When > 0, a solve with NO warm start runs from this
    # initial rho instead of ``rho`` (its shared KKT factor is built
    # under a scalar lax.cond, so warm solves pay nothing).  The closed-
    # loop production rho (0.01) is tuned for the warm regime's f32
    # iteration floor; the cold first solve prefers a much stiffer
    # penalty — measured on the quadrotor cold batch (TPU v5e, B=4096):
    # rho 0.01 -> 195.1 mean iterations (p50 AT the 250 cap), rho 0.1 ->
    # 52.3 (p50 40), with adaptive rho handling the rest of the path.
    # 0 disables (cold solves use ``rho``, OSQP parity).
    cold_rho: float = 0.0
    # advance the warm start one stage along the horizon before each solve
    # (receding-horizon realignment; lmpc/problem.py::shift_warm_start).
    # The reference reuses the previous solution unshifted
    # (LOptimizer.hpp:372) — default off for parity.  On closed loops the
    # shift halves the p99 iteration count, compressing the lockstep tail;
    # leave it off when consecutive solves share the same state (e.g.
    # re-solving an unchanged problem), where the unshifted start is exact.
    warm_start_shift: bool = False
    sigma: float = 1e-6
    scaling_iters: int = 10
    # run each iteration block through the hand-written fused kernel
    # (ops/admm_fused.py: the CUDA kernel for CUDA tensors, its plain twin
    # for CPU tensors); False runs the plain PyTorch iteration loop.  The
    # name is the JAX package's, where it selects the Pallas TPU kernel.
    use_pallas: bool = True


@dataclasses.dataclass(frozen=True)
class NLParameters(Parameters):
    """SQP parameters (reference: include/mpc/Types.hpp:121-140).

    The field names, defaults and the measurements quoted in the comments
    are the JAX package's (taken on a TPU).  In this port ``inner_qp="fused"``
    is the hand-written CUDA kernel of ``ops/qp_inner_fused.py`` (float32,
    up to the JAX package's size gate for its fused engine, restated in
    ``ops/sqp.py``) and ``"riccati"`` the banded-KKT interior point of
    ``ops/trajectory_kkt.py`` through the CUDA kernels of
    ``ops/trajectory_sweeps.py``, which also serves a ``"fused"`` request in
    float64 or past that size when the controller verified the NLP's
    stage-local structure (routing: ``ops/sqp.py::inner_engine``, the JAX
    package's).  ``"admm"`` is the per-instance ADMM of
    ``ops/admm.py::admm_solve_each`` (each lane's own scaling, rho and KKT
    inverse, the inverses through the batched kernel of
    ``ops/batched_linalg.py``), which also serves an oversize float32
    ``"fused"`` request without a verified structure.

    ``hessian_reg`` (TPU-native extension) selects the curvature model of
    the QP subproblem:

    * ``"gershgorin"`` (default): exact Lagrangian Hessian shifted by a
      Gershgorin bound — no factorization at all.  Default because the
      hardware sweep measured it 2.6x faster than ``"eigh"`` at identical
      100% success on the production batch (45.2k vs 17.2k solves/s,
      misc/results/SWEEP_TPU_r2_batch2.txt) — the batched eigh is the
      single most expensive per-iteration op at large batch and its
      tighter steps do not pay for themselves on the shipped examples.
    * ``"eigh"``: exact Lagrangian Hessian with eigenvalue clipping — the
      tightest convex model and fewest SQP iterations; worth selecting for
      hard nonconvex instances where step quality dominates wall time.
    * ``"bfgs"``: damped-BFGS quasi-Newton matrix (the family SLSQP itself
      uses — algorithm-parity mode, ~2-3x more iterations, no Hessian).
    * ``"power"``: exact Hessian shifted by a power-iteration estimate of
      ``-lambda_min`` (pure matvecs, tighter than Gershgorin).
    * ``"gauss_newton"``: objective-Hessian-only model, evaluated ONCE per
      solve and reused by every iteration (exact for quadratic tracking
      costs; constraint curvature dropped).  The scaling mode for large
      problems — per-iteration cost stops paying the dense O(nz^2)
      Lagrangian Hessian + O(nz^3) eigh entirely.
    """

    relative_ftol: float = -1.0
    relative_xtol: float = -1.0
    absolute_ftol: float = -1.0
    absolute_xtol: float = -1.0
    hard_constraints: bool = True
    hessian_reg: str = "gershgorin"
    # inner QP engine (TPU-native extension): "fused" (default) runs the
    # whole batch of float32 subproblems in ONE Pallas kernel per SQP
    # iteration (ops/qp_inner_pallas.py: in-VMEM Cholesky + ADMM loop,
    # batch in lanes — the fast production path; float64 solves fall back
    # to "pdip", and problems past the kernel's VMEM gate fall back to
    # "riccati" when the structure probe verified the plan, else "admm");
    # "riccati" solves each subproblem with the banded-KKT interior-point
    # method (ops/trajectory_kkt.py: Mehrotra IPM whose Newton systems
    # factor as a bordered block-tridiagonal LDL^T over the horizon — the
    # scaling engine for large trajectory NLPs, requires the verified
    # stage-local structure and a gauss_newton/gershgorin/power curvature
    # mode; degrades to "pdip" otherwise); "pdip" solves each subproblem
    # with a dense Mehrotra predictor-corrector interior-point method
    # (~20 iterations of small batched factorizations — the accuracy-
    # reference engine and the f64 default); "admm" uses the shared
    # OSQP-style XLA kernel
    inner_qp: str = "fused"
    # TPU-native extension (the reference has verbose only on LParameters):
    # prints a per-solve SQP iteration summary, mirroring LMPC's behavior
    verbose: bool = False
    # batched-solve straggler compaction (TPU-native extension): run the
    # SQP loop in short full-batch chunks until the unconverged count
    # falls to ~1/4 of the batch, then gather those instances and finish
    # only them.  The per-instance iteration sequence is preserved
    # exactly (chunking partitions the same loop); results can differ at
    # rounding level only through the fused inner-QP kernel's lane-tile
    # membership.  Applies to batched solves with batch >= 128.
    # Default OFF: the hardware A/B at the production bench size measured
    # it neutral-to-slightly-negative (44.4k vs 45.3k solves/s,
    # misc/results/SWEEP_TPU_r2_batch2.txt) — worth enabling only when
    # per-instance NLPs are large enough that the straggler tail dominates.
    compact_stragglers: bool = False
    # trajectory-IPM iteration policy (TPU-native extension, applies to the
    # "riccati" banded-KKT inner engine only).  ``inner_iters`` caps the
    # Mehrotra IPM per subproblem (0 = the measured flat-45 default);
    # setting ``inner_iters_recovery`` above it escalates a lane's cap
    # after an outer line-search failure (folded into the done mask, so
    # the compiled loop keeps a static trip bound).  Escalation was
    # measured SLOWER than the flat default on the oscillator bench
    # (lockstep pays the max lane's cap and failing lanes are per-step
    # common: esc30/60 214 vs flat45 329 solves/s at equal success,
    # misc/ab_osc_escalation.py) — the knobs remain for families with
    # genuinely rare deep lanes; prefer ``rescue_iters`` otherwise.
    inner_iters: int = 0
    inner_iters_recovery: int = 0
    # compacted two-phase rescue in closed-loop rollouts (TPU-native
    # extension, rollout.py).  When > 0: each rollout step first solves
    # the whole batch at the configured (fast) settings, then gathers the
    # lanes whose solve FAILED — at most max(16, B//16) of them — and
    # re-solves only those from the same entry state with the IPM cap set
    # to this value, scattering the recovered results back.  A step with
    # no failures skips the rescue entirely, so the
    # deep cap is paid only where a lane actually failed, at compacted
    # batch cost instead of full-batch lockstep cost.
    rescue_iters: int = 0
    # per-lane warm-start reset after a FAILED solve (TPU-native
    # extension, closed-loop rollouts).  A lane whose solve ended
    # roundoff-limited at an infeasible point carries its stuck iterate
    # into the next step's (shifted) warm start and tends to stay stuck
    # for several consecutive steps while the held command drives the
    # plant blind (measured on the UGV obstacle benchmark: every f32
    # obstacle incursion coincides with such a failure run,
    # misc/diagnose_ugv.py).  With this flag the failed lane re-enters
    # from the cold initial guess (X=x0, U=u0) at the next step instead —
    # healthy lanes keep their warm starts.  The reference carries its
    # opt_vector unconditionally (NLOptimizer.hpp:426-510); this is a
    # deliberate, measured deviation for failure recovery.
    cold_restart_on_failure: bool = False


@dataclasses.dataclass(frozen=True)
class Result:
    """Optimization result (reference: include/mpc/Types.hpp:168-182).

    Tensors may carry a leading batch axis.  ``solver_status_msg`` is a
    host-side string, populated by the controller wrapper only.
    """

    cmd: torch.Tensor  # (..., nu)
    cost: torch.Tensor  # (...,)
    status: torch.Tensor  # (...,) int32, values of ResultStatus
    solver_status: torch.Tensor  # (...,) int32 raw solver code
    is_feasible: torch.Tensor  # (...,) bool
    solver_status_msg: str = ""

    @property
    def status_enum(self) -> ResultStatus:
        """Host-side convenience for unbatched results."""
        return ResultStatus(int(self.status))


@dataclasses.dataclass(frozen=True)
class OptSequence:
    """Optimal sequences over the horizon (reference: include/mpc/Types.hpp:184-198).

    Shapes are (..., ph+1, nx / ny / nu): row 0 holds the initial state like
    the reference (LOptimizer.hpp:304-338).
    """

    state: torch.Tensor
    output: torch.Tensor
    input: torch.Tensor


def zero_result(nu: int, dtype=None, batch: tuple = (), device=None) -> Result:
    dtype = dtype or default_dtype()
    device = resolve_device(device)
    return Result(
        cmd=torch.zeros(batch + (nu,), dtype=dtype, device=device),
        cost=torch.zeros(batch, dtype=dtype, device=device),
        status=torch.full(batch, int(ResultStatus.UNKNOWN), dtype=torch.int32,
                          device=device),
        solver_status=torch.zeros(batch, dtype=torch.int32, device=device),
        is_feasible=torch.zeros(batch, dtype=torch.bool, device=device),
    )


def zero_sequence(nx: int, ny: int, nu: int, ph: int, dtype=None,
                  batch: tuple = (), device=None) -> OptSequence:
    dtype = dtype or default_dtype()
    device = resolve_device(device)
    return OptSequence(
        state=torch.zeros(batch + (ph + 1, nx), dtype=dtype, device=device),
        output=torch.zeros(batch + (ph + 1, ny), dtype=dtype, device=device),
        input=torch.zeros(batch + (ph + 1, nu), dtype=dtype, device=device),
    )
