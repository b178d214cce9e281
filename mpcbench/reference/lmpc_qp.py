"""Plain reference of a linear MPC step: the optimal first command.

The problem is libmpc++'s linear MPC (``include/mpc/LMPC/ProblemBuilder.hpp``
of the upstream project) written from its definition: the state is augmented
with the last command, ``s = [x; u_prev]``, the decision is the command
increment ``du``, and with ``s_0 = [x0; u_prev]``

    s_{i+1} = [[A, B], [0, I]] s_i + [[B], [I]] du_i          i = 0 .. ph-1
    cost    = sum_{i=1..ph} 1/2 |[C x_i; u_{i-1}] - [y_ref; u_ref]|^2_W
              + sum_i 1/2 w_du |du_i|^2
    bounds    x_min <= x_i <= x_max,  u_min <= u_{i-1} <= u_max    i = 1 .. ph

The served command is ``u_0 = u_prev + du_0``.  The step-0 terms are
constants and are left out.  The QP is condensed onto ``du`` (ph*nu
variables) and solved by :mod:`qp_ipm`.  Weights and bounds are the same at
every step of the horizon, as the configurations here set them; a control
horizon shorter than the prediction horizon is not modelled.
"""

from __future__ import annotations

import torch

from . import qp_ipm


def _bound(v, missing):
    """Bounds as floats, ``None`` (no bound) as ``missing``."""
    return [missing if x is None else float(x) for x in v]


class LinearMPC:
    """The condensed QP of one configuration, built once in float64."""

    def __init__(self, cfg: dict, device):
        f64 = dict(dtype=torch.float64, device=device)
        A = torch.tensor(cfg["Ad"], **f64)
        Bm = torch.tensor(cfg["Bd"], **f64)
        C = torch.tensor(cfg["C"], **f64)
        nx, nu = Bm.shape
        ph = cfg["ph"]
        if cfg["ch"] != ph:
            raise ValueError("the reference models ch == ph only")
        nxu = nx + nu
        sA = torch.zeros((nxu, nxu), **f64)
        sA[:nx, :nx], sA[:nx, nx:], sA[nx:, nx:] = A, Bm, torch.eye(nu, **f64)
        sB = torch.cat([Bm, torch.eye(nu, **f64)])
        sC = torch.block_diag(C, torch.eye(nu, **f64))
        # S = Phi s0 + Gam du, S stacking s_1 .. s_ph
        Phi = torch.zeros((ph, nxu, nxu), **f64)
        Gam = torch.zeros((ph, nxu, ph, nu), **f64)
        P = torch.eye(nxu, **f64)
        for i in range(ph):
            P = sA @ P
            Phi[i] = P
            for j in range(i + 1):
                Gam[i, :, j] = torch.linalg.matrix_power(sA, i - j) @ sB
        Phi = Phi.reshape(ph * nxu, nxu)
        Gam = Gam.reshape(ph * nxu, ph * nu)
        W = torch.diag(torch.tensor(list(cfg["output_weight"]) + list(cfg["input_weight"]),
                                    **f64))
        Qi = sC.T @ W @ sC
        Q = torch.block_diag(*([Qi] * ph))
        e_ref = torch.tensor(list(cfg["output_reference"]) + [0.0] * nu, **f64)
        qi = -(sC.T @ W @ e_ref)
        self.q = qi.repeat(ph)
        self.H = Gam.T @ Q @ Gam + torch.diag(
            torch.tensor(list(cfg["delta_input_weight"]) * ph, **f64))
        self.Q, self.Phi, self.Gam = Q, Phi, Gam
        inf = float("inf")
        lo = _bound(cfg["state_min"], -inf) + _bound(cfg["input_min"], -inf)
        hi = _bound(cfg["state_max"], inf) + _bound(cfg["input_max"], inf)
        rows, signs, limits = [], [], []
        for i in range(ph):
            for k in range(nxu):
                if hi[k] != inf:
                    rows.append(i * nxu + k), signs.append(1.0), limits.append(hi[k])
                if lo[k] != -inf:
                    rows.append(i * nxu + k), signs.append(-1.0), limits.append(-lo[k])
        self.rows = torch.tensor(rows, device=device)
        self.signs = torch.tensor(signs, **f64)
        self.limits = torch.tensor(limits, **f64)
        self.G = self.signs[:, None] * Gam[self.rows]
        self.nx, self.nu, self.nxu = nx, nu, nxu

    def commands(self, x0, u_prev, dtype=torch.float64, tf32=False):
        """First commands (B, nu) at states ``x0`` (B, nx) after commands
        ``u_prev`` (B, nu), and whether each lane's solve converged.  The
        solve runs in ``dtype`` (TF32 products where ``tf32``)."""
        c = lambda t: t.to(dtype)
        with qp_ipm.matmul_precision(tf32):
            s0 = c(torch.cat([x0, u_prev], dim=1))
            free = s0 @ c(self.Phi).T  # (B, ph*nxu): the states with du = 0
            g = (free @ c(self.Q) + c(self.q)) @ c(self.Gam)
            h = c(self.limits) - c(self.signs) * free[:, self.rows]
        du, conv = qp_ipm.solve(c(self.H), g, c(self.G), h, tf32=tf32)
        with qp_ipm.matmul_precision(tf32):
            s1 = free[:, : self.nxu] + du @ c(self.Gam[: self.nxu]).T
        return s1[:, self.nx:].to(torch.float64), conv
