"""Numerical integrators for user vector fields.

``rk4`` mirrors the classic Runge-Kutta-4 utility (reference:
include/mpc/Integrator.hpp:16-56), as ``libmpc_tpu/utils/integrators.py``
does; here the sub-steps are a plain Python loop over tensors.  Like the
reference, it is a user-facing utility.
"""

from __future__ import annotations

from typing import Callable


def rk4_step(f: Callable, x, u, h):
    """One classic RK4 step of ``dx/dt = f(x, u)``."""
    k1 = f(x, u)
    k2 = f(x + 0.5 * h * k1, u)
    k3 = f(x + 0.5 * h * k2, u)
    k4 = f(x + h * k3, u)
    return x + (h / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


def rk4(f: Callable, x0, u, h, steps: int):
    """Integrate ``steps`` RK4 sub-steps with constant input ``u``.

    Matches ``RK4::run`` semantics (reference: include/mpc/Integrator.hpp:16-56).
    """
    x = x0
    for _ in range(steps):
        x = rk4_step(f, x, u, h)
    return x
