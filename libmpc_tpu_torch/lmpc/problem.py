"""Linear MPC QP assembly.

Port of ``libmpc_tpu/lmpc/problem.py``: builds the same sparse/simultaneous
QP as the reference's ``ProblemBuilder`` (reference:
include/mpc/LMPC/ProblemBuilder.hpp:70-76, 642-822) as dense block
operations over tensors, so a batch of instances assembles in one pass.

Formulation (identical to the reference):

* The state is augmented with the previous input, ``x_aug = [x; x_u]`` with
  ``x_u(k) = u(k-1)``, so the QP input is the *increment* ``du``
  (ProblemBuilder.hpp:190-209)::

      ssA = [[A, B], [0, I]]   ssB = [[B], [I]]   ssC = [[C, 0], [0, I]]

* Decision vector ``z = [x_aug_0 .. x_aug_ph ; du_0 .. du_{ph-1}]`` of length
  ``(ph+1)(nx+nu) + ph*nu`` (ProblemBuilder.hpp:70-76).
* Constraint rows, in order (ProblemBuilder.hpp:704-822):
  dynamics equalities | box on x_aug | output rows ``C x`` | du box |
  scalar constraint.

Horizon-dependent quantities are *time-major* ``(ph+1, feature)`` tensors,
as in the JAX package.  Float32 matrix products run at full float32
precision: the solver sets TF32 off before it assembles
(``ops/admm.py::full_precision``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..dims import LDims
from ..types import default_dtype, inf, resolve_device


@dataclasses.dataclass(frozen=True)
class LProblemData:
    """Time-invariant data of the linear MPC problem.

    Mirrors the mutable fields of ``ProblemBuilder``
    (reference: include/mpc/LMPC/ProblemBuilder.hpp:826-857) as an immutable
    record; setters in the controller produce updated copies.

    Index-0 convention: slots ``[0]`` of the (ph+1)-length tensors
    correspond to the initial-state row and are kept equal to slot ``[1]``
    by the controller's setters, matching the reference's column-0
    duplication (ProblemBuilder.hpp:254-262).
    """

    # augmented state-space model
    ssA: torch.Tensor  # (nxu, nxu)
    ssB: torch.Tensor  # (nxu, nu)
    ssC: torch.Tensor  # (ny+nu, nxu)
    ssBv: torch.Tensor  # (nxu, ndu)
    ssDv: torch.Tensor  # (ny+nu, ndu)
    # objective weights, time-major
    w_out: torch.Tensor  # (ph+1, ny)
    w_u: torch.Tensor  # (ph+1, nu)
    w_du: torch.Tensor  # (ph, nu)
    # box bounds, time-major (may carry a leading batch axis)
    min_x: torch.Tensor  # (ph+1, nx)
    max_x: torch.Tensor
    min_y: torch.Tensor  # (ph+1, ny)
    max_y: torch.Tensor
    min_u: torch.Tensor  # (ph, nu)
    max_u: torch.Tensor
    # scalar constraint
    s_min: torch.Tensor  # (ph+1,)
    s_max: torch.Tensor  # (ph+1,)
    s_mult: torch.Tensor  # (nxu,) single [X; U] row replicated per step


def init_problem(dims: LDims, dtype=None, device=None) -> LProblemData:
    """Default-initialized problem: zero model/weights, +-inf bounds
    (reference: include/mpc/LMPC/ProblemBuilder.hpp:120-149)."""
    dtype = dtype or default_dtype()
    device = resolve_device(device)
    nxu = dims.nxu
    z = lambda *s: torch.zeros(s, dtype=dtype, device=device)
    full = lambda v, *s: torch.full(s, v, dtype=dtype, device=device)
    return LProblemData(
        ssA=z(nxu, nxu),
        ssB=z(nxu, dims.nu),
        ssC=z(dims.ny + dims.nu, nxu),
        ssBv=z(nxu, dims.ndu),
        ssDv=z(dims.ny + dims.nu, dims.ndu),
        w_out=z(dims.ph + 1, dims.ny),
        w_u=z(dims.ph + 1, dims.nu),
        w_du=z(dims.ph, dims.nu),
        min_x=full(-inf, dims.ph + 1, dims.nx),
        max_x=full(inf, dims.ph + 1, dims.nx),
        min_y=full(-inf, dims.ph + 1, dims.ny),
        max_y=full(inf, dims.ph + 1, dims.ny),
        min_u=full(-inf, dims.ph, dims.nu),
        max_u=full(inf, dims.ph, dims.nu),
        s_min=full(-inf, dims.ph + 1),
        s_max=full(inf, dims.ph + 1),
        s_mult=z(nxu),
    )


def make_augmented_model(A, B, C):
    """Augment (A, B, C) with the input-memory states
    (reference: include/mpc/LMPC/ProblemBuilder.hpp:190-209)."""
    nx, nu = B.shape
    ny = C.shape[0]
    kw = dict(dtype=A.dtype, device=A.device)
    eye_u = torch.eye(nu, **kw)
    ssA = torch.cat([
        torch.cat([A, B], dim=1),
        torch.cat([torch.zeros((nu, nx), **kw), eye_u], dim=1),
    ])
    ssB = torch.cat([B, eye_u])
    ssC = torch.cat([
        torch.cat([C, torch.zeros((ny, nu), **kw)], dim=1),
        torch.cat([torch.zeros((nu, nx), **kw), eye_u], dim=1),
    ])
    return ssA, ssB, ssC


def make_disturbance_model(Bd, Dd, nu: int):
    """Lift disturbance maps into the augmented space
    (reference: include/mpc/LMPC/ProblemBuilder.hpp:222-236)."""
    ndu = Bd.shape[1]
    pad = torch.zeros((nu, ndu), dtype=Bd.dtype, device=Bd.device)
    return torch.cat([Bd, pad]), torch.cat([Dd, pad])


def build_time_invariant(
    dims: LDims, prob: LProblemData
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Assemble P, A and the static inequality bounds.

    Mirrors ``buildTimeInvariantTems``
    (reference: include/mpc/LMPC/ProblemBuilder.hpp:642-822).  Returns
    ``(P, A, lineq, uineq)`` where lineq/uineq cover only the inequality rows
    (the equality RHS is time-varying).
    """
    ph, ch = dims.ph, dims.ch
    nx, nu, ny = dims.nx, dims.nu, dims.ny
    nxu = dims.nxu
    kw = dict(dtype=prob.ssA.dtype, device=prob.ssA.device)

    # -- P: per-step ssC' W ssC blocks + du weights ----------------------
    # W_i = diag([w_out_i; w_u_i])  (ProblemBuilder.hpp:651-667)
    w_ext = torch.cat([prob.w_out, prob.w_u], dim=1)  # (ph+1, ny+nu)
    blocks = prob.ssC.T @ (w_ext[:, :, None] * prob.ssC)  # (ph+1, nxu, nxu)
    P = torch.zeros((dims.nz, dims.nz), **kw)
    P[: dims.n_aug, : dims.n_aug] = torch.block_diag(*blocks)
    P[dims.n_aug :, dims.n_aug :] = torch.diag(prob.w_du.reshape(-1))

    # -- Aeq: kron(I,-I) + kron(downshift, ssA) | kron(downshift_B, ssB) --
    # (ProblemBuilder.hpp:671-702)
    eye_h = torch.eye(ph + 1, **kw)
    down = torch.zeros((ph + 1, ph + 1), **kw)
    down[1:, :-1] = torch.eye(ph, **kw)
    down_b = torch.zeros((ph + 1, ph), **kw)
    down_b[1:, :] = torch.eye(ph, **kw)
    Aeq_x = torch.kron(eye_h, -torch.eye(nxu, **kw)) + torch.kron(down, prob.ssA)
    Aeq_u = torch.kron(down_b, prob.ssB)
    Aeq = torch.cat([Aeq_x, Aeq_u], dim=1)

    # -- Aineq rows ------------------------------------------------------
    # box rows on x_aug (identity), output rows kron(I, ssC[:ny]),
    # du identity rows, scalar row (ProblemBuilder.hpp:704-822)
    Aineq = torch.zeros((dims.n_ineq, dims.nz), **kw)
    Aineq[: dims.n_box, : dims.n_aug] = torch.eye(dims.n_box, **kw)
    Aineq[dims.n_box : dims.n_box + dims.n_out, : dims.n_aug] = torch.kron(
        eye_h, prob.ssC[:ny, :]
    )
    r0 = dims.n_box + dims.n_out
    Aineq[r0 : r0 + dims.n_dub, dims.n_aug :] = torch.eye(dims.n_dub, **kw)
    r1 = r0 + dims.n_dub
    Aineq[r1:, : dims.n_aug] = torch.kron(eye_h, prob.s_mult[None, :])

    A = torch.cat([Aeq, Aineq], dim=0)

    # -- static inequality bounds ----------------------------------------
    # box: [min_x_i ; min_u_{min(i, ph-1)}] per step (ProblemBuilder.hpp:735-749).
    # Bound tensors may carry a leading batch axis (per-instance bounds for
    # fleet solves); the model/weight terms above stay shared.
    batch = torch.broadcast_shapes(
        prob.min_x.shape[:-2], prob.min_u.shape[:-2], prob.min_y.shape[:-2],
        prob.s_min.shape[:-1],
    )
    bcast = lambda a, tail: torch.broadcast_to(a, batch + tail)
    u_idx = torch.clamp(torch.arange(ph + 1, device=kw["device"]), max=ph - 1)

    def box(xb, ub):
        return torch.cat(
            [bcast(xb, (ph + 1, nx)), bcast(ub[..., u_idx, :], (ph + 1, nu))],
            dim=-1,
        ).reshape(batch + (-1,))

    # du rows: free through step ch, pinned to 0 after (ProblemBuilder.hpp:782-793)
    pinned = (torch.arange(ph, device=kw["device"]) > ch)[:, None]
    du_min = torch.where(pinned, 0.0, -inf) * torch.ones((1, nu), **kw)
    du_max = torch.where(pinned, 0.0, inf) * torch.ones((1, nu), **kw)

    lineq = torch.cat(
        [
            box(prob.min_x, prob.min_u),
            bcast(prob.min_y, (ph + 1, ny)).reshape(batch + (-1,)),
            torch.broadcast_to(du_min.reshape(-1), batch + (ph * nu,)),
            bcast(prob.s_min, (ph + 1,)),
        ],
        dim=-1,
    )
    uineq = torch.cat(
        [
            box(prob.max_x, prob.max_u),
            bcast(prob.max_y, (ph + 1, ny)).reshape(batch + (-1,)),
            torch.broadcast_to(du_max.reshape(-1), batch + (ph * nu,)),
            bcast(prob.s_max, (ph + 1,)),
        ],
        dim=-1,
    )
    return P, A, lineq, uineq


def _step_rows(ref, ph: int):
    """Rows ``max(i-1, 0)`` of a (..., ph, f) reference for i in 0..ph."""
    idx = torch.clamp(torch.arange(ph + 1, device=ref.device) - 1, min=0)
    return ref[..., idx, :]


def build_time_varying(
    dims: LDims,
    prob: LProblemData,
    lineq: torch.Tensor,
    uineq: torch.Tensor,
    x0: torch.Tensor,
    u0: torch.Tensor,
    y_ref: torch.Tensor,
    u_ref: torch.Tensor,
    du_ref: torch.Tensor,
    u_meas: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-step (q, l, u) assembly.

    Mirrors ``ProblemBuilder::get``
    (reference: include/mpc/LMPC/ProblemBuilder.hpp:528-633).  References and
    measured disturbances are (ph, feature) time-major; horizon slot i uses
    row ``max(i-1, 0)`` because slot 0 is the current state
    (ProblemBuilder.hpp:564-577).

    All tensor arguments may carry a leading batch axis (broadcast rules make
    the same code serve both); ``x0``/``u0`` shaped (..., nx) / (..., nu).
    """
    ph = dims.ph
    ny = dims.ny

    y_ref_e = _step_rows(y_ref, ph)  # (..., ph+1, ny)
    u_ref_e = _step_rows(u_ref, ph)
    du_ref_e = _step_rows(du_ref, ph)
    u_meas_e = _step_rows(u_meas, ph)  # (..., ph+1, ndu)

    # q over x_aug blocks: ssC' W_i (-eRef_i + ssDv d_i)  (hpp:586-587)
    e_ref = torch.cat([y_ref_e, u_ref_e], dim=-1)  # (..., ph+1, ny+nu)
    w_ext = torch.cat([prob.w_out, prob.w_u], dim=1)  # (ph+1, ny+nu)
    inner = w_ext * (-e_ref + u_meas_e @ prob.ssDv.T)
    q_aug = inner @ prob.ssC  # (..., ph+1, nxu)

    # q over du blocks: -w_du_i * du_ref_i for i < ph (hpp:590-594)
    q_du = -(prob.w_du * du_ref_e[..., :ph, :])

    batch = torch.broadcast_shapes(
        x0.shape[:-1], u0.shape[:-1], y_ref.shape[:-2], u_meas.shape[:-2],
        lineq.shape[:-1],
    )
    q_aug = torch.broadcast_to(q_aug, batch + q_aug.shape[-2:])
    q_du = torch.broadcast_to(q_du, batch + q_du.shape[-2:])
    q = torch.cat(
        [q_aug.reshape(batch + (-1,)), q_du.reshape(batch + (-1,))], dim=-1
    )

    # equality RHS: block 0 = [-x0; -u0], block i>0 = -ssBv d_{i-1} (hpp:597-613)
    leq_head = -torch.cat(_bcast_cat(x0, u0), dim=-1)[..., None, :]  # (..., 1, nxu)
    leq_tail = -(u_meas_e[..., 1:, :] @ prob.ssBv.T)  # (..., ph, nxu)
    leq_head = torch.broadcast_to(leq_head, batch + leq_head.shape[-2:])
    leq_tail = torch.broadcast_to(leq_tail, batch + leq_tail.shape[-2:])
    leq = torch.cat([leq_head, leq_tail], dim=-2).reshape(batch + (-1,))

    # inequality offsets on the output rows: -ssDv[:ny] d_i (hpp:605-607)
    out_off = -(u_meas_e @ prob.ssDv[:ny, :].T)
    out_off = torch.broadcast_to(out_off, batch + out_off.shape[-2:]).reshape(
        batch + (-1,)
    )
    offset = torch.zeros(batch + (dims.n_ineq,), dtype=q.dtype, device=q.device)
    offset[..., dims.n_box : dims.n_box + out_off.shape[-1]] = out_off

    l = torch.cat(
        [leq, torch.broadcast_to(lineq, batch + lineq.shape[-1:]) + offset], dim=-1
    )
    u = torch.cat(
        [leq, torch.broadcast_to(uineq, batch + uineq.shape[-1:]) + offset], dim=-1
    )
    return q, l, u


def _bcast_cat(x0, u0):
    """[x0, u0] broadcast to their joint batch shape."""
    batch = torch.broadcast_shapes(x0.shape[:-1], u0.shape[:-1])
    return [torch.broadcast_to(x0, batch + x0.shape[-1:]),
            torch.broadcast_to(u0, batch + u0.shape[-1:])]


def unpack_solution(dims: LDims, prob: LProblemData, z: torch.Tensor,
                    u_meas: torch.Tensor):
    """Extract (state, input, output) sequences from the QP solution.

    Mirrors the unpack loop (reference: include/mpc/LMPC/LOptimizer.hpp:304-338):
    states are the first nx entries of each augmented block; inputs are the
    x_u component *shifted forward one step* (``x_u(k) = u(k-1)``), with the
    last row repeated; outputs come from ``mapToOutput`` with the step's
    measured disturbance.
    """
    ph, nx, ny = dims.ph, dims.nx, dims.ny
    batch = z.shape[:-1]
    aug = z[..., : dims.n_aug].reshape(batch + (ph + 1, dims.nxu))
    states = aug[..., :nx]
    xu = aug[..., nx:]
    shift_idx = torch.clamp(torch.arange(ph + 1, device=z.device) + 1, max=ph)
    inputs = xu[..., shift_idx, :]

    u_meas_e = _step_rows(u_meas, ph)
    outputs = states @ prob.ssC[:ny, :nx].T + u_meas_e @ prob.ssDv[:ny, :].T
    return states, inputs, outputs


def map_to_output(prob: LProblemData, ny: int, nx: int, state, meas_dist):
    """``y = C x + Dd d`` (reference: include/mpc/LMPC/ProblemBuilder.hpp:514-517)."""
    return state @ prob.ssC[:ny, :nx].T + meas_dist @ prob.ssDv[:ny, :].T


def _shift_stages(vec, n_stages: int, width: int):
    """Roll per-stage blocks one stage earlier, duplicating the last stage."""
    blocks = vec.reshape(vec.shape[:-1] + (n_stages, width))
    blocks = torch.cat([blocks[..., 1:, :], blocks[..., -1:, :]], dim=-2)
    return blocks.reshape(vec.shape[:-1] + (n_stages * width,))


def shift_warm_start(dims: LDims, warm_x, warm_y):
    """Advance an LMPC warm start one control step along the horizon.

    The reference warm-starts OSQP with the *unshifted* previous solution
    (include/mpc/LMPC/LOptimizer.hpp:372); after the plant advances one step
    that guess is misaligned by one stage.  Rolling every per-stage block of
    the primal (augmented states, then du moves) and the dual (dynamics,
    state-box, output, du-box and scalar rows — the row layout of
    :func:`build_time_invariant`) one stage earlier and duplicating the
    terminal stage re-aligns it (``libmpc_tpu/lmpc/problem.py:378``).
    """
    warm_x = torch.cat(
        [
            _shift_stages(warm_x[..., : dims.n_aug], dims.ph + 1, dims.nxu),
            _shift_stages(warm_x[..., dims.n_aug :], dims.ph, dims.nu),
        ],
        dim=-1,
    )
    segments = (
        (dims.ph + 1, dims.nxu),  # dynamics equality rows
        (dims.ph + 1, dims.nxu),  # state/input box rows
        (dims.ph + 1, dims.ny),   # output rows
        (dims.ph, dims.nu),       # delta-u box rows
        (dims.ph + 1, 1),         # scalar-constraint rows
    )
    parts, offset = [], 0
    for n_stages, width in segments:
        size = n_stages * width
        parts.append(
            _shift_stages(warm_y[..., offset : offset + size], n_stages, width)
        )
        offset += size
    return warm_x, torch.cat(parts, dim=-1)
