"""Plain reference of a Van der Pol NLMPC step (libmpc++ ``examples/vanderpol_ex.cpp``).

The NLP, as libmpc++'s nonlinear MPC states it for the example, written from
its definitions at the state x_0 (``ts`` the sampling time, ``h = ts / 2``):

    decision  z = [x_1 .. x_ph ; u_0 .. u_{ch-1} ; e]
    states    X_0 = x_0, X_k = x_k                        (Mapping.hpp)
    inputs    U_k = u_{min(k, ch-1)} for k < ph, U_ph = U_{ph-1}: the blocked
              moves, the last one held to the horizon's end (Mapping.hpp)
    minimize  sum_{k=0..ph} |X_k|^2 + sum_{k=0..ph} |U_k|^2
    subject to X_k + h (f(X_k, U_k) + f(X_{k+1}, U_k)) - X_{k+1} = 0
                                      k = 0 .. ph-1  (Constraints.hpp:533-545)
               U_k - u_max <= 0       k = 0 .. ph

with the continuous model ``f(x, u) = A x + B u - mu x_1^2 x_0 e_1`` (the
oscillator ``[mu (1 - x_1^2) x_0 - x_1 + u, x_0]``).  The slack ``e`` of the
soft constraints is bounded to [0, 0] under the example's hard constraints
(libmpc++'s default), and its functions do not read it, so the reference
leaves it out.  The rows U_k <= u_max for k >= ch-1 all bound the last move;
the reference keeps one row a move (the duplicates change no optimum).

The NLP is not convex, so the reference does not search for a minimizer of
its own: it starts Newton's method at the program's plan and finds the local
minimizer there, to a KKT residual of 1e-10 in float64.  Each iteration is a
full-space SQP step with exact derivatives from ``torch.autograd``: the
Lagrangian's Hessian over every state and move, the multipliers of the
defects estimated from the state rows of stationarity (their Jacobian block
is invertible), and the QP subproblem solved exactly: its linearized defects
eliminate the states' step, and the moves' box is solved by trying every
active set of the ch rows and keeping the one that satisfies the KKT
conditions.  Nothing here is shared with the program under test.

The working precision is ``dtype``.  In a precision that
``torch.linalg.solve_ex`` does not take (bfloat16), the solves run in float32
and their results are rounded back.
"""

from __future__ import annotations

import itertools

import torch


def floor(dtype) -> float:
    """The KKT residual a lane converges to: 1e-10 in float64, else 32 unit
    roundoffs of the working precision."""
    if dtype == torch.float64:
        return 1e-10
    return 32 * torch.finfo(dtype).eps / 2


class VanDerPolMPC:
    """The NLP of one configuration (``mpcbench/configs/vanderpol-nlmpc.json``)."""

    def __init__(self, cfg: dict, device):
        self.nx, self.nu, self.ph, self.ch = cfg["nx"], cfg["nu"], cfg["ph"], cfg["ch"]
        if self.nu != 1:
            raise ValueError("the reference models one input")
        self.ts, self.mu, self.u_max = float(cfg["ts"]), float(cfg["mu"]), float(cfg["u_max"])
        self.A = torch.tensor(cfg["A"], dtype=torch.float64, device=device)
        self.B = torch.tensor(cfg["B"], dtype=torch.float64, device=device)
        self.n_x = self.ph * self.nx  # states in the decision
        # row k of U takes blocked move min(k, ch-1), so row ph repeats row
        # ph-1 (ch <= ph)
        self.hold = torch.clamp(torch.arange(self.ph + 1, device=device), max=self.ch - 1)

    # -- the model and the NLP (batched, any float dtype) -------------------
    def f(self, x, u):
        """f(x, u) for x (..., nx), u (..., nu)."""
        A, B = self.A.to(x.dtype), self.B.to(x.dtype)
        lin = x @ A.T + u @ B.T
        cubic = self.mu * x[..., 1] * x[..., 1] * x[..., 0]
        return torch.stack([lin[..., 0] - cubic, lin[..., 1]], dim=-1)

    def unpack(self, z, x0):
        """(X (B, ph+1, nx), U (B, ph+1, nu)) of decisions z (B, ph nx + ch nu)."""
        X = torch.cat([x0[:, None, :], z[:, : self.n_x].reshape(-1, self.ph, self.nx)], dim=1)
        U = z[:, self.n_x:].reshape(-1, self.ch, self.nu)[:, self.hold]
        return X, U

    def cost(self, z, x0):
        X, U = self.unpack(z, x0)
        return (X * X).sum(dim=(1, 2)) + (U * U).sum(dim=(1, 2))

    def defects(self, z, x0):
        """The trapezoidal defects (B, ph nx)."""
        X, U = self.unpack(z, x0)
        h = self.ts / 2
        c = X[:, :-1] + h * (self.f(X[:, :-1], U[:, :-1]) + self.f(X[:, 1:], U[:, :-1])) \
            - X[:, 1:]
        return c.reshape(z.shape[0], -1)

    def first_defect(self, x0, x1, u0):
        """The k = 0 defect (B, nx) of a plan's first state ``x1`` under the
        first move ``u0``."""
        h = self.ts / 2
        return x0 + h * (self.f(x0, u0) + self.f(x1, u0)) - x1

    # -- Newton's method ------------------------------------------------------
    def _derivatives(self, z, x0):
        """Objective gradient g (B, n), defects c (B, me), their Jacobian J
        (B, me, n), each row by reverse-mode autograd."""
        z = z.detach().requires_grad_(True)
        c = self.defects(z, x0)
        (g,) = torch.autograd.grad(self.cost(z, x0).sum(), z)
        J = torch.stack([torch.autograd.grad(c[:, r].sum(), z, retain_graph=True)[0]
                         for r in range(c.shape[1])], dim=1)
        return g, c.detach(), J

    def _lagrangian_hessian(self, z, x0, lam):
        z = z.detach().requires_grad_(True)
        L = self.cost(z, x0) + (lam * self.defects(z, x0)).sum(dim=1)
        (gL,) = torch.autograd.grad(L.sum(), z, create_graph=True)
        return torch.stack([torch.autograd.grad(gL[:, i].sum(), z, retain_graph=True)[0]
                            for i in range(z.shape[1])], dim=1)

    def _kkt(self, z, x0, solve):
        """(KKT residual (B,), multipliers of the defects, g, c, J) at z.  The
        multipliers make the state rows of stationarity hold exactly; the
        residual is the largest of |c| and the moves' natural residual
        |u - min(u_max, u - (g_u + J_u' lam))|."""
        g, c, J = self._derivatives(z, x0)
        nxs = self.n_x
        Jx, Ju = J[:, :, :nxs], J[:, :, nxs:]
        lam = solve(Jx.transpose(1, 2), -g[:, :nxs, None])[:, :, 0]
        grad_u = g[:, nxs:] + (Ju.transpose(1, 2) @ lam[:, :, None])[:, :, 0]
        u = z[:, nxs:]
        nat = u - torch.clamp(u - grad_u, max=self.u_max)
        res = torch.maximum(c.abs().amax(dim=1), nat.abs().amax(dim=1))
        return res, lam, g, c, J

    def _box_qp(self, H, g, hi, solve):
        """min 1/2 d'Hd + g'd s.t. d <= hi for a batch of small positive
        definite H (B, p, p): every active set is solved, and the one with
        the least violation of feasibility and of the multipliers' signs is
        kept (for a convex QP exactly one satisfies the KKT conditions)."""
        Bn, p = g.shape
        sets = torch.tensor(list(itertools.product((False, True), repeat=p)),
                            device=g.device)  # (2^p, p): row i active?
        act = sets[:, None, :, None]  # (S, 1, p, 1)
        eye = torch.eye(p, dtype=H.dtype, device=H.device)
        K = torch.where(act, eye, H[None])  # active rows pin d_i = hi_i
        rhs = torch.where(sets[:, None, :], hi[None], -g[None])
        d = solve(K, rhs[..., None])[..., 0]  # (S, B, p)
        mult = -((H[None] @ d[..., None])[..., 0] + g[None])  # d_i <= hi_i's multiplier
        viol = torch.where(sets[:, None, :], -mult, d - hi[None]).clamp(min=0).amax(dim=2)
        viol = torch.nan_to_num(viol, nan=float("inf"))
        best = viol.argmin(dim=0)
        return d[best, torch.arange(Bn, device=g.device)]

    def solve(self, x0, X_plan, U_plan, dtype=torch.float64, iters=12,
              min_iters=2):
        """The local minimizer at states ``x0`` (B, nx) from the plan (X_plan
        (B, ph+1, nx), U_plan (B, ph+1, nu)), in ``dtype``.  Takes at least
        ``min_iters`` Newton steps, then stops a lane at :func:`floor`.
        Returns (first moves (B, nu), states (B, ph+1, nx), inputs (B, ph+1,
        nu), converged (B,)), all float64."""
        sdt = dtype if dtype in (torch.float32, torch.float64) else torch.float32

        def solve_(M, r):
            # a singular system gives a lane no finite step, never an exception
            return torch.linalg.solve_ex(M.to(sdt), r.to(sdt))[0].to(dtype)

        tol = floor(dtype)
        nxs = self.n_x
        x0 = x0.to(dtype)
        z = torch.cat([X_plan[:, 1:].reshape(x0.shape[0], -1),
                       U_plan[:, : self.ch].reshape(x0.shape[0], -1)], dim=1).to(dtype)
        done = torch.zeros(x0.shape[0], dtype=torch.bool, device=x0.device)
        for it in range(iters + 1):
            res, lam, g, c, J = self._kkt(z, x0, solve_)
            done = done | ((res < tol) & (it >= min_iters))
            if it == iters or bool(done.all()):
                break
            H = self._lagrangian_hessian(z, x0, lam)
            # eliminate the states' step: Jx dx + Ju du = -c
            Jx, Ju = J[:, :, :nxs], J[:, :, nxs:]
            a = -solve_(Jx, c[:, :, None])[:, :, 0]
            T = -solve_(Jx, Ju)
            Z = torch.cat([T, torch.eye(self.ch * self.nu, dtype=dtype,
                                        device=x0.device).expand(x0.shape[0], -1, -1)],
                          dim=1)  # (B, n, ch nu)
            d0 = torch.cat([a, torch.zeros_like(z[:, nxs:])], dim=1)
            Zt = Z.transpose(1, 2)
            Hr = Zt @ H @ Z
            gr = (Zt @ (g + (H @ d0[:, :, None])[:, :, 0])[:, :, None])[:, :, 0]
            du = self._box_qp(Hr, gr, self.u_max - z[:, nxs:], solve_)
            step = d0 + (Z @ du[:, :, None])[:, :, 0]
            z = torch.where(done[:, None], z, z + step)
        conv = done & torch.isfinite(z).all(dim=1)
        X, U = self.unpack(z, x0)
        f64 = lambda t: t.to(torch.float64)
        return f64(U[:, 0]), f64(X), f64(U), conv
