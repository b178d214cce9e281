"""Exact ZOH discretization of linear systems via the matrix exponential.

Mirrors the three overloads of ``mpc::discretization``
(reference: include/mpc/Utils.hpp:24-118), as ``libmpc_tpu/utils/
discretization.py`` does, using ``torch.linalg.matrix_exp``: the block
matrix ``[[A, B], [0, 0]] * Ts`` is exponentiated and the discrete (Ad, Bd)
blocks read back.
"""

from __future__ import annotations

import torch


def _as_tensor(a):
    return a if isinstance(a, torch.Tensor) else torch.as_tensor(a, dtype=torch.float64)


def discretization(A, B, Ts):
    """ZOH-discretize ``dx = A x + B u`` (reference: include/mpc/Utils.hpp:24-47).

    Returns ``(Ad, Bd)`` with ``x+ = Ad x + Bd u``.
    """
    A = _as_tensor(A)
    B = _as_tensor(B).to(A.dtype)
    nx, nu = A.shape[0], B.shape[1]
    block = torch.zeros((nx + nu, nx + nu), dtype=A.dtype, device=A.device)
    block[:nx] = torch.cat([A, B], dim=1) * Ts
    e = torch.linalg.matrix_exp(block)
    return e[:nx, :nx], e[:nx, nx : nx + nu]


def discretization_with_disturbance(A, B, Be, Ts):
    """ZOH with disturbance input (reference: include/mpc/Utils.hpp:63-89).

    Returns ``(Ad, Bd, Bed)``.
    """
    A = _as_tensor(A)
    B = _as_tensor(B).to(A.dtype)
    Be = _as_tensor(Be).to(A.dtype)
    nx, nu, nud = A.shape[0], B.shape[1], Be.shape[1]
    n = nx + nu + nud
    block = torch.zeros((n, n), dtype=A.dtype, device=A.device)
    block[:nx] = torch.cat([A, B, Be], dim=1) * Ts
    e = torch.linalg.matrix_exp(block)
    return e[:nx, :nx], e[:nx, nx : nx + nu], e[:nx, nx + nu :]


def discretization_with_output(A, B, C, D, Ts):
    """ZOH of the state equation, pass-through C/D
    (reference: include/mpc/Utils.hpp:108-118).

    Returns ``(Ad, Bd, Cd, Dd)``.
    """
    Ad, Bd = discretization(A, B, Ts)
    return Ad, Bd, _as_tensor(C), _as_tensor(D)
