"""Plain reference of an obstacle-avoiding double-integrator MPC step.

The NLP, as libmpc++'s nonlinear MPC states it for ``examples/ugv_ex.cpp``
(decision: the states x_1 .. x_ph and the moves u_0 .. u_{ph-1}, ch = ph),
written from its definition at state x_0 with ``v_ref`` the unit vector from
the position to the goal:

    minimize  w_v sum_{k=0..ph} |v_k - v_ref|^2 + w_u sum_{k=0..ph} |U_k|^2
              (U_k = u_k for k < ph and U_ph = u_{ph-1}, the upstream
              convention of holding the last move)
    subject to x_{k+1} = Ad x_k + Bd u_k                     k = 0 .. ph-1
               r_j - |p_k - o_j| <= 0                         k = 1 .. ph, every j

with ``(Ad, Bd)`` the zero-order hold of the continuous model.  The slack of
the soft constraints enters only its own cost, so it is 0 at every optimum
and left out; the k = 0 rows are constants.

The NLP is not convex and has several local optima, so the reference does
not search for one.  It judges the program's answer: each obstacle row
``r - |p - o|`` is concave in ``p``, so its linearization at the answer's
positions is a tangent half-space inside the feasible set, and a KKT point
of the NLP is the unique optimum of the convex QP with those half-spaces
(the same gradients and multipliers satisfy its KKT conditions, which are
sufficient for a convex QP).  :func:`ObstacleMPC.solve` condenses that QP
onto the moves and solves it with :mod:`qp_ipm`; its first move is what the
program's command is held against.
"""

from __future__ import annotations

import torch

from . import qp_ipm


def zoh(A, B, ts):
    """Zero-order-hold discretization by the matrix exponential of the
    augmented system."""
    nx, nu = B.shape
    M = torch.zeros((nx + nu, nx + nu), dtype=A.dtype, device=A.device)
    M[:nx, :nx], M[:nx, nx:] = A * ts, B * ts
    E = torch.linalg.matrix_exp(M)
    return E[:nx, :nx], E[:nx, nx:]


class ObstacleMPC:
    """The condensed dynamics and cost of one configuration, in float64."""

    def __init__(self, cfg: dict, device):
        f64 = dict(dtype=torch.float64, device=device)
        Ad, Bd = zoh(torch.tensor(cfg["A"], **f64), torch.tensor(cfg["B"], **f64), cfg["ts"])
        nx, nu = Bd.shape
        ph = cfg["ph"]
        if cfg["ch"] != ph:
            raise ValueError("the reference models ch == ph only")
        # X_k = Phi_k x0 + Gam_k u for k = 0 .. ph
        Phi = torch.zeros((ph + 1, nx, nx), **f64)
        Gam = torch.zeros((ph + 1, nx, ph, nu), **f64)
        Phi[0] = torch.eye(nx, **f64)
        for k in range(ph):
            Phi[k + 1] = Ad @ Phi[k]
            Gam[k + 1] = torch.einsum("ij,jtu->itu", Ad, Gam[k])
            Gam[k + 1, :, k] = Bd
        self.Phi, self.Gam = Phi, Gam.reshape(ph + 1, nx, ph * nu)
        self.ph, self.nx, self.nu = ph, nx, nu
        wv, wu = float(cfg["velocity_weight"]), float(cfg["input_weight"])
        held = torch.ones(ph, **f64)
        held[-1] = 2.0  # U_ph repeats u_{ph-1}
        Gv = self.Gam[:, 2:4]  # (ph+1, 2, n): velocities
        # 1/2 u'Hu + g'u = the cost / 2 up to a constant
        self.H = wv * torch.einsum("kin,kim->nm", Gv, Gv) + wu * torch.diag(
            held.repeat_interleave(nu))
        self.wv = wv
        self.obstacles = torch.tensor(cfg["obstacles"], **f64)
        self.radii = torch.tensor(cfg["radii"], **f64)
        self.goal = torch.tensor(cfg["goal"], **f64)

    def solve(self, x0, positions, dtype=torch.float64, tf32=False):
        """The convex QP's optimum at states ``x0`` (B, nx), its obstacle
        rows tangent at ``positions`` (B, ph+1, 2) (rows 1 .. ph used), in
        ``dtype``.  Returns (first moves (B, nu), states (B, ph+1, nx),
        converged (B,))."""
        c = lambda t: t.to(dtype)
        with qp_ipm.matmul_precision(tf32):
            x0 = c(x0)
            Phi, Gam = c(self.Phi), c(self.Gam)
            free = torch.einsum("kij,bj->bki", Phi, x0)  # (B, ph+1, nx)
            d = self.goal.to(dtype) - x0[:, 0:2]
            v_ref = d / torch.linalg.vector_norm(d, dim=1, keepdim=True)
            err = free[:, :, 2:4] - v_ref[:, None, :]  # (B, ph+1, 2)
            g = self.wv * torch.einsum("kin,bki->bn", Gam[:, 2:4], err)
            # tangent rows n'(p_k - o) >= r for k = 1 .. ph and each obstacle
            p_hat = c(positions)[:, 1:, None, :]  # (B, ph, 1, 2)
            o = c(self.obstacles)[None, None]  # (1, 1, J, 2)
            nrm = p_hat - o
            nrm = nrm / torch.linalg.vector_norm(nrm, dim=-1, keepdim=True)  # (B, ph, J, 2)
            Gp = Gam[1:, 0:2]  # (ph, 2, n)
            G = -torch.einsum("bkji,kin->bkjn", nrm, Gp)
            h = -c(self.radii)[None, None] + torch.einsum(
                "bkji,bkji->bkj", nrm, free[:, 1:, None, 0:2] - o)
            B, rows = x0.shape[0], G.shape[1] * G.shape[2]
            G, h = G.reshape(B, rows, G.shape[-1]), h.reshape(B, rows)
        u, conv = qp_ipm.solve(c(self.H), g, G, h, tf32=tf32)
        with qp_ipm.matmul_precision(tf32):
            X = free + torch.einsum("kin,bn->bki", Gam, u)
        return u[:, : self.nu].to(torch.float64), X.to(torch.float64), conv
