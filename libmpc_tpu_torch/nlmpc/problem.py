"""Nonlinear MPC functional core.

Port of ``libmpc_tpu/nlmpc/problem.py``.  The reference decomposes the NLP
into Model/Mapping/Objective/Constraints objects with mutable state and
finite-difference derivatives
(reference: include/mpc/NLMPC/{Model,Mapping,Objective,Constraints}.hpp).
Here the same mathematics is a set of *pure functions of the decision
vector*, written for ONE instance (1-D ``z``, ``x0``) and differentiated
exactly with ``torch.func`` by the SQP solver, which also supplies the batch
axis with ``torch.func.vmap``.

Decision vector (identical to the reference, NLOptimizer.hpp:64)::

    z = [x_1 .. x_ph  (ph*nx, scaled states) ;
         u_0 .. u_{ch-1} (nu*ch, scaled blocked moves) ;
         slack (1)]

Move blocking: the ch blocked moves expand to ph steps with the last move
held for ``ph-ch+1`` steps (Mapping.hpp:221-257) — expressed as a gather
instead of the reference's Iz2u matmul.  Row ``ph`` of U duplicates row
``ph-1`` (Mapping.hpp:194).

Scaling: physical state = decision / state_scaling; physical input =
input_scaling * decision (Sz2u diag blocks, Mapping.hpp:236-242).

User callables are per-instance torch functions on 1-D tensors; the stage
index ``k`` reaches them as a 0-d tensor (they must not branch on it), and
they must not write in place (``torch.func.vmap`` refuses it): build results
with ``torch.stack``/``torch.cat``.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Callable, NamedTuple, Optional

import torch
from torch.func import vmap

from ..dims import NLDims


@dataclasses.dataclass(frozen=True)
class NLFunctions:
    """User-supplied model callables (the analog of the reference's handle
    typedefs, IDimensionable.hpp:94-149), in return-value style like the
    Python bindings (python/pybind_export.cpp:20-57):

    * ``state_fn(x, u, k) -> dx``  (continuous) or ``-> x_next`` (discrete)
    * ``output_fn(x, u, k) -> y``  (optional)
    * ``objective_fn(X, Y, U, slack) -> scalar``
    * ``ineq_fn(X, Y, U, slack) -> (ineq,)``  (feasible iff <= 0)
    * ``eq_fn(X, U) -> (eq,)``  (feasible iff == 0)

    Every callable may optionally take one extra trailing argument ``p`` —
    a *runtime-parameter* pytree of tensors supplied per solve via
    ``NLMPC.set_runtime_params`` (e.g. moving obstacle positions, varying
    references).  Stored callables here are already canonicalized to the
    p-taking form.
    """

    state_fn: Optional[Callable] = None
    output_fn: Optional[Callable] = None
    objective_fn: Optional[Callable] = None
    ineq_fn: Optional[Callable] = None
    eq_fn: Optional[Callable] = None
    continuous: bool = False
    ts: float = 0.0

    def __post_init__(self):
        # accept both plain and p-taking user callbacks at construction
        for name, arity in (("state_fn", 3), ("output_fn", 3),
                            ("objective_fn", 4), ("ineq_fn", 4), ("eq_fn", 2)):
            object.__setattr__(self, name, canonicalize(getattr(self, name), arity))


def canonicalize(handle: Optional[Callable], base_arity: int) -> Optional[Callable]:
    """Wrap a user callback so it always accepts the trailing runtime-param
    pytree (ignored when the user's signature doesn't declare it)."""
    if handle is None:
        return None
    try:
        sig_params = inspect.signature(handle).parameters.values()
    except (TypeError, ValueError):
        return handle
    if any(p.kind == inspect.Parameter.VAR_POSITIONAL for p in sig_params):
        return handle  # *args-style callables receive everything
    if len(sig_params) >= base_arity + 1:
        return handle
    return lambda *args: handle(*args[:base_arity])


class Unwrapped(NamedTuple):
    X: torch.Tensor  # (ph+1, nx) physical states, row 0 = x0
    U: torch.Tensor  # (ph+1, nu) physical inputs, row ph duplicates ph-1
    slack: torch.Tensor  # scalar


def block_index(ph: int, ch: int, device=None) -> torch.Tensor:
    """Row -> blocked-move index implementing Iz2u as a gather
    (reference: include/mpc/NLMPC/Mapping.hpp:221-257)."""
    idx = torch.clamp(torch.arange(ph, device=device), max=ch - 1)
    return torch.cat([idx, idx[-1:]])  # row ph duplicates row ph-1


def unwrap(dims: NLDims, z, x0, state_scaling, input_scaling) -> Unwrapped:
    """Decision vector -> (X, U, slack)
    (reference: include/mpc/NLMPC/Mapping.hpp:174-211).

    Note the reference divides the *whole* X matrix — including the x0 row —
    by the state scaling; reproduced faithfully.
    """
    ph, ch, nx, nu = dims.ph, dims.ch, dims.nx, dims.nu
    xs = z[: ph * nx].reshape(ph, nx)
    X = torch.cat([x0[None, :], xs], dim=0) / state_scaling[None, :]
    ub = z[ph * nx : ph * nx + nu * ch].reshape(ch, nu) * input_scaling[None, :]
    U = ub[block_index(ph, ch, z.device)]
    return Unwrapped(X=X, U=U, slack=z[-1])


def _stages(fn: Callable, X, U, n: int, p):
    """``fn(x_k, u_k, k, p)`` over the first ``n`` stages (the stage vmap of
    the JAX package, ``in_axes=(0, 0, 0, None)``)."""
    ks = torch.arange(n, device=X.device)
    return vmap(lambda x, u, k: fn(x, u, k, p))(X, U, ks)


def get_output(dims: NLDims, fns: NLFunctions, X, U, p=None):
    """Output trajectory; zeros when no output model
    (reference: include/mpc/NLMPC/Model.hpp:72-96)."""
    if fns.output_fn is None:
        return torch.zeros((dims.ph + 1, dims.ny), dtype=X.dtype, device=X.device)
    return _stages(fns.output_fn, X, U, dims.ph + 1, p)


def objective(dims: NLDims, fns: NLFunctions, state_scaling, input_scaling, z, x0, p=None):
    """User cost as a scalar function of z (the gradient comes from
    ``torch.func.grad``, replacing Objective.hpp:198-265's forward
    differences)."""
    X, U, slack = unwrap(dims, z, x0, state_scaling, input_scaling)
    Y = get_output(dims, fns, X, U, p)
    return fns.objective_fn(X, Y, U, slack, p)


def state_defects(dims: NLDims, fns: NLFunctions, state_scaling, input_scaling, z, x0, p=None):
    """Dynamics defect equality residuals, (ph*nx,).

    Continuous models use the trapezoidal rule with the reference's exact
    convention ``c_k = x_k + (Ts/2)(f(x_k,u_k) + f(x_{k+1},u_k)) - x_{k+1}``
    (Constraints.hpp:533-545 — note h = Ts/2 and both evaluations share u_k);
    discrete models use ``c_k = x_{k+1} - f(x_k, u_k)`` (Constraints.hpp:
    592-595).  Residuals are divided by the state scaling like the reference.
    """
    X, U, _ = unwrap(dims, z, x0, state_scaling, input_scaling)
    xk = X[:-1]
    xk1 = X[1:]
    uk = U[:-1]
    f = lambda xs: _stages(fns.state_fn, xs, uk, dims.ph, p)
    if fns.continuous:
        h = fns.ts / 2.0
        c = xk + h * (f(xk) + f(xk1)) - xk1
    else:
        c = xk1 - f(xk)
    return (c / state_scaling[None, :]).reshape(-1)


def user_ineq(dims: NLDims, fns: NLFunctions, state_scaling, input_scaling, z, x0, p=None):
    """User inequality values (Constraints.hpp:211-316)."""
    X, U, slack = unwrap(dims, z, x0, state_scaling, input_scaling)
    Y = get_output(dims, fns, X, U, p)
    return fns.ineq_fn(X, Y, U, slack, p)


def user_eq(dims: NLDims, fns: NLFunctions, state_scaling, input_scaling, z, x0, p=None):
    """User equality values (Constraints.hpp:365-442)."""
    X, U, _ = unwrap(dims, z, x0, state_scaling, input_scaling)
    return fns.eq_fn(X, U, p)


def shift_warm_start(dims: NLDims, z):
    """One-step receding-horizon shift of the previous solution
    (reference: include/mpc/NLMPC/NLOptimizer.hpp:460-507): states and
    expanded inputs move left one step with the last entry duplicated.
    ``z`` may carry leading batch axes."""
    ph, ch, nx, nu = dims.ph, dims.ch, dims.nx, dims.nu
    lead = z.shape[:-1]
    xs = z[..., : ph * nx].reshape(lead + (ph, nx))
    xs = xs[..., torch.clamp(torch.arange(ph, device=z.device) + 1, max=ph - 1), :]
    ub = z[..., ph * nx : ph * nx + nu * ch].reshape(lead + (ch, nu))
    # expanded shift collapses back to: blocked moves roll left, last held
    ub = ub[..., torch.clamp(torch.arange(ch, device=z.device) + 1, max=ch - 1), :]
    return torch.cat(
        [xs.reshape(lead + (-1,)), ub.reshape(lead + (-1,)), z[..., -1:]], dim=-1
    )


def initial_guess(dims: NLDims, x0, u0, slack, dtype=None):
    """Cold-start guess: states pinned at x0, moves at u0
    (reference: include/mpc/NLMPC/NLOptimizer.hpp:431-451).  ``x0``/``u0``
    /``slack`` may carry leading batch axes."""
    dtype = dtype or x0.dtype
    x0 = x0.to(dtype)
    reps = (1,) * (x0.dim() - 1)
    xs = x0.repeat(reps + (dims.ph,))
    us = u0.to(dtype).repeat(reps + (dims.ch,))
    slack = torch.as_tensor(slack, dtype=dtype, device=x0.device)
    slack = slack.expand(x0.shape[:-1])[..., None]
    return torch.cat([xs, us, slack], dim=-1)


def fix_bounds(z, lb, ub):
    """Clamp out-of-bounds entries to (ub-lb)/2 — reproducing the reference's
    half-width (not midpoint) repair exactly
    (reference: include/mpc/NLMPC/NLOptimizer.hpp:705-716)."""
    bad = (z < lb) | (z > ub)
    return torch.where(bad, (ub - lb) / 2.0, z)


def is_feasible(dims: NLDims, fns: NLFunctions, state_scaling, input_scaling,
                z, x0, ineq_tol, eq_tol, p=None):
    """User-constraint feasibility verdict (defects are NOT checked, matching
    Constraints.hpp:157-202).

    The user tolerance is floored at ~32 ulps of the constraint scale in the
    working precision: the reference's 1e-10 default is meaningful in
    double, but a float32 solve cannot certify an ACTIVE constraint tighter
    than one ulp of its bound (~6e-8 at 0.5) — without the floor the
    verdict would flip with the last-bit rounding of whichever inner engine
    produced the iterate.  In float64 the floor (~1e-14) sits below every
    reference default and changes nothing.
    """
    eps_m = 1.2e-7 if z.dtype == torch.float32 else 2.2e-16

    def tol_floor(user_tol, v):
        return torch.clamp(32.0 * eps_m * (1.0 + torch.abs(v)), min=user_tol)

    ok = torch.ones((), dtype=torch.bool, device=z.device)
    if fns.ineq_fn is not None:
        v = user_ineq(dims, fns, state_scaling, input_scaling, z, x0, p)
        ok = ok & torch.all(v <= tol_floor(ineq_tol, v))
    if fns.eq_fn is not None:
        v = user_eq(dims, fns, state_scaling, input_scaling, z, x0, p)
        ok = ok & torch.all(torch.abs(v) <= tol_floor(eq_tol, v))
    return ok
