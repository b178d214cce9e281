"""Model-parallel (row-sharded) ADMM for large QPs.

Port of ``libmpc_tpu/parallel/qp_sharded.py``.  The batch of scenarios is
the first scaling axis, but one problem can outgrow a device: long
horizons, or plant-wide MPC with thousands of constraint rows.
:func:`solve_sharded` splits the constraint rows of ``A``/``l``/``u`` (and
the iterates ``z``/``y``) over the ``model`` axis of a ``(data, model)``
mesh and the batch over its ``data`` axis, and every rank runs the same
solver as one process does (``ops/admm.py::admm_solve`` with
``axis_rows``/``axis_batch``): Ruiz equilibration, per-row rho, adaptive
rho, both infeasibility certificates and the polish, with SUMs over the row
shards for the cross-space products, MAXes for the row norms, and the
batch-global statistics reduced over ``data``, so that the sharded batch
solves as the unsharded one does.

Every rank calls it with the whole problem, as the fleets do, and gets the
whole solution back.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ..ops import admm
from ..types import LParameters
from . import mesh as mesh_lib
from .mesh import DATA_AXIS, MODEL_AXIS, Mesh


class ShardedQPSolution(NamedTuple):
    x: torch.Tensor  # (B, n)
    y: torch.Tensor  # (B, m) (unpadded)
    iters: torch.Tensor  # (B,)
    status: torch.Tensor  # (B,) OSQP status values
    obj_val: torch.Tensor  # (B,)
    pri_res: torch.Tensor  # (B,)
    dua_res: torch.Tensor  # (B,)


def solve_sharded(
    P,
    A,
    q,
    l,
    u,
    mesh: Mesh,
    params: LParameters = LParameters(),
    eq_mask=None,
    warm_x=None,
    warm_y=None,
) -> ShardedQPSolution:
    """Solve a batch of QPs with the constraint rows sharded over ``model``
    and the batch over ``data``: the solver of
    :func:`libmpc_tpu_torch.ops.admm.admm_solve`, every feature included.

    Shapes: P (n, n); A (m, n); q (B, n); l/u (B, m); ``warm_x`` (B, n),
    ``warm_y`` (B, m) or None.  Tensors or arrays, the same on every rank;
    the dtype is ``P``'s, the device the mesh's.  B must divide over the
    data axis (``ValueError`` on every rank, before any collective); rows
    are zero-padded to a multiple of the model axis with unconstrained
    bounds, so the pad rows are loose and never active.  ``eq_mask`` (m,)
    defaults to the rows with ``l == u`` in every instance.  A primal-only
    warm start gets zero duals, and warm vectors turn
    ``enable_warm_start`` on.

    Every rank returns the whole solution: x, the statuses, iterations,
    objectives and residuals gathered over ``data``, y over ``model`` and
    then ``data``, unpadded.  The row axis is passed even when ``model`` is
    1 (so the solve runs the plain iterations, as in the JAX package), and
    the batch axis when ``data`` is above 1.
    """
    n_model, n_data = mesh.shape[MODEL_AXIS], mesh.shape[DATA_AXIS]
    dev = mesh.device
    P = torch.as_tensor(P, device=dev)
    dtype = P.dtype
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
    A, q, l, u = t(A), t(q), t(l), t(u)
    B, n = q.shape
    m = A.shape[0]
    if B % n_data:
        raise ValueError(f"batch {B} must divide over data axis {n_data}")

    if eq_mask is None:
        eq_mask = torch.all((l == u) & torch.isfinite(l), dim=0)
    eq_mask = torch.as_tensor(eq_mask, dtype=torch.bool, device=dev)

    # pad rows to a multiple of the model axis with unconstrained zero rows
    # (the solver gives loose rows rho_min; Ruiz's limit keeps their scaling
    # at 1)
    m_pad = mesh_lib.pad_to_multiple(m, n_model)
    pad = m_pad - m
    if pad:
        A = torch.cat([A, A.new_zeros((pad, n))])
        l = torch.cat([l, l.new_full((B, pad), float("-inf"))], dim=1)
        u = torch.cat([u, u.new_full((B, pad), float("inf"))], dim=1)
        eq_mask = torch.cat([eq_mask, eq_mask.new_zeros(pad)])
    have_warm = warm_x is not None
    if have_warm:
        warm_x = t(warm_x)
        # primal-only warm start: zero duals, as ops/admm.py defaults them
        warm_y = A.new_zeros((B, m_pad)) if warm_y is None else t(warm_y)
        if warm_y.shape[-1] == m and pad:
            warm_y = torch.cat([warm_y, warm_y.new_zeros((B, pad))], dim=1)
        if not params.enable_warm_start:
            # warm vectors supplied explicitly: honour them
            params = dataclasses.replace(params, enable_warm_start=True)

    rows = mesh.rows(B)
    per = m_pad // n_model
    blk = slice(mesh.model_index * per, (mesh.model_index + 1) * per)
    sol = admm.admm_solve(
        P, A[blk].contiguous(), q[rows], l[rows, blk], u[rows, blk], params,
        warm_x=warm_x[rows] if have_warm else None,
        warm_y=warm_y[rows, blk] if have_warm else None,
        eq_mask=eq_mask[blk],
        axis_rows=mesh.axis(MODEL_AXIS),
        axis_batch=mesh.axis(DATA_AXIS) if n_data > 1 else None,
    )

    # y's row blocks over the model axis (rows of y.T), then one gather over
    # the data axis of every per-lane field packed as float64 (exact for
    # either dtype and for the integer codes)
    y = mesh_lib.all_gather_rows(mesh, sol.y.T.contiguous(), MODEL_AXIS).T
    fields = (sol.status, sol.iters, sol.obj_val, sol.pri_res, sol.dua_res)
    packed = torch.cat([sol.x.to(torch.float64), y.to(torch.float64)]
                       + [f[:, None].to(torch.float64) for f in fields], dim=1)
    full = mesh_lib.all_gather_rows(mesh, packed, DATA_AXIS)
    status, iters, obj, pri, dua = full[:, n + m_pad:].T
    return ShardedQPSolution(
        x=full[:, :n].to(dtype),
        y=full[:, n:n + m].to(dtype),
        iters=iters.to(sol.iters.dtype),
        status=status.to(sol.status.dtype),
        obj_val=obj.to(dtype),
        pri_res=pri.to(dtype),
        dua_res=dua.to(dtype),
    )
