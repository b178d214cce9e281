"""The Van der Pol NLMPC: the controller, the plant and the check.

Builds ``libmpc_tpu_torch.NLMPC`` from ``vanderpol-nlmpc.json`` as
``examples/vanderpol_ex.cpp`` of libmpc++ sets it up: the continuous-time
oscillator ``f(x, u) = A x + B u - mu x1^2 x0 e1`` discretized at ``ts`` by the
NLP's trapezoidal defects, ph=10, ch=5, the objective ``sum X^2 + sum U^2`` and
the inequality ``U[:, 0] - u_max``, with the fleet settings the file names.
The plant is the example's explicit Euler step ``x + ts f(x, u)``, plus the
traffic's process noise.

Cold start: the fresh controller's state is saved with ``save_state`` into
memory before its first solve, and every episode begins with ``load_state``
of it, which makes the next ``optimize`` a first one.

The check, on every kept lane-step whose status is SUCCESS: the served
command against the first move of the plain reference's local minimizer,
found by Newton's method from the program's own plan
(``reference/vdp_nlp.py``, float64; a lane where it does not converge reads
an infinite gap); and the first trapezoidal defect of the plan under the
served command.
"""

from __future__ import annotations

import io

import torch

from mpcbench.loop import System
from mpcbench.reference import vdp_nlp


def model(cfg, **kw):
    """f(x, u) of one instance (1-D x and u), from the file's A, B and mu."""
    A, B = torch.tensor(cfg["A"], **kw), torch.tensor(cfg["B"], **kw)
    e1 = torch.tensor([1.0, 0.0], **kw)
    mu = float(cfg["mu"])
    return lambda x, u: A @ x + B @ u - mu * x[1] * x[1] * x[0] * e1


def build(cfg, traffic, device) -> System:
    import libmpc_tpu_torch as lt

    dtype = getattr(torch, cfg["dtype"])
    kw = dict(dtype=dtype, device=device)
    nx, nu = cfg["nx"], cfg["nu"]
    f = model(cfg, **kw)
    ts, u_max = cfg["ts"], cfg["u_max"]

    c = lt.NLMPC(nx, nu, cfg["ny"], cfg["ph"], cfg["ch"], cfg["ineq"], cfg["eq"], **kw)
    c.set_discretization_sampling_time(ts)
    c.set_state_space_function(lambda x, u, k: f(x, u))
    c.set_objective_function(lambda X, Y, U, e: torch.sum(X ** 2) + torch.sum(U ** 2))
    c.set_ineq_con_function(lambda X, Y, U, e: U[:, 0] - u_max)
    c.set_optimizer_parameters(lt.NLParameters(**cfg["solver"]))
    buf = io.BytesIO()
    c.save_state(buf)
    cold = buf.getvalue()
    f_batch = torch.func.vmap(f)

    def plant(x, u, noise):
        x = x + ts * f_batch(x, u)
        return x if noise is None else x + noise

    def keep(idx, x, u_prev, r):
        seq = c.get_optimal_sequence()
        return {"x": x[idx], "cmd": r.cmd[idx], "status": r.status[idx],
                "plan": seq.state[idx], "plan_u": seq.input[idx]}

    return System(controller=c, nx=nx, nu=nu, dtype=dtype, device=device,
                  reset=lambda: c.load_state(io.BytesIO(cold)), plant=plant, keep=keep,
                  success=int(lt.ResultStatus.SUCCESS))


def answers(cfg, samples, device, dtype=torch.float64, tf32=False):
    """The reference's moves at the kept states, each lane's Newton's method
    started at the program's plan, in ``dtype``: float64 for the check, the
    control's lower precision in the program's place.

    The control is asked for as float32 with TF32 products and computes in
    bfloat16 instead: TF32 lands where float32 does, because the defects and
    gradients are evaluated elementwise and Newton's method refines away the
    rounding of the products.

    Every lane counts as answered: where Newton's method does not converge
    from the plan, the command is NaN, so the check reads that lane's gap as
    infinite instead of leaving the lane out."""
    if tf32:
        dtype = torch.bfloat16
    ref = vdp_nlp.VanDerPolMPC(cfg, device)
    f64 = lambda t: t.to(device=device, dtype=torch.float64)
    cmd, X, U, conv = ref.solve(f64(samples["x"]), f64(samples["plan"]),
                                f64(samples["plan_u"]), dtype)
    cmd = torch.where(conv[:, None], cmd, torch.nan)
    return {"cmd": cmd, "plan": X, "plan_u": U, "converged": torch.ones_like(conv)}


def residuals(cfg, samples, device):
    """Per lane: the first trapezoidal defect of the plan (its first
    predicted state) under the served command."""
    ref = vdp_nlp.VanDerPolMPC(cfg, device)
    f64 = lambda t: t.to(device=device, dtype=torch.float64)
    gap = ref.first_defect(f64(samples["x"]), f64(samples["plan"])[:, 1], f64(samples["cmd"]))
    return {"defect_gap": gap.abs().amax(dim=1)}
