"""The UGV NLMPC: the controller, the plant and the check.

Builds ``libmpc_tpu_torch.NLMPC`` from ``ugv-nlmpc.json`` as
``examples/ugv_ex.cpp`` of libmpc++ sets it up (a double integrator, two
circular obstacles, velocity tracking toward the goal), with the port's
shipped fleet settings the file names.  Before every step the velocity
reference ``v_pref`` of each lane is recomputed from its state and handed
over with ``set_runtime_params(..., batched=True)``, as the example's loop
does.  The plant is the discretized model itself.

Cold start: the builder saves the fresh controller's state with
``save_state`` into memory before its first solve, and every episode begins
with ``load_state`` of it, which makes the next ``optimize`` a first one.

The check, on every kept lane-step whose status is SUCCESS: the served
command against the first move of the plain reference's convex QP, its
obstacle rows tangent at the program's own predicted positions
(``reference/ugv_nlp.py``, float64); and the plan's first predicted state
against the model's step under the served command.
"""

from __future__ import annotations

import io

import numpy as np
import torch

from mpcbench.loop import System
from mpcbench.reference import ugv_nlp


def build(cfg, traffic, device) -> System:
    import libmpc_tpu_torch as lt

    dtype = getattr(torch, cfg["dtype"])
    kw = dict(dtype=dtype, device=device)
    nx, nu, ph = cfg["nx"], cfg["nu"], cfg["ph"]
    B = int(traffic["batch"])
    Ad, Bd = (M.to(**kw) for M in lt.discretization(np.array(cfg["A"], float),
                                                     np.array(cfg["B"], float), cfg["ts"]))
    obstacles = torch.tensor(cfg["obstacles"], **kw)
    radii = torch.tensor(cfg["radii"], **kw)
    goal = torch.tensor(cfg["goal"], **kw)
    wv, wu, we = cfg["velocity_weight"], cfg["input_weight"], cfg["slack_weight"]

    c = lt.NLMPC(nx, nu, cfg["ny"], ph, cfg["ch"], cfg["ineq"], cfg["eq"], **kw)
    c.set_state_space_function(lambda x, u, k: Ad @ x + Bd @ u)
    c.set_output_function(lambda x, u, k: x)

    def objective(X, Y, U, e, p):
        v_err = X[:, 2:4] - p["v_pref"][None, :]
        return wv * torch.sum(v_err ** 2) + wu * torch.sum(U ** 2) + we * e * e

    def ineq(X, Y, U, e):
        d = torch.sqrt(torch.sum((X[:, None, 0:2] - obstacles[None, :, :]) ** 2, dim=-1))
        return (radii[None, :] - d).reshape(-1)

    c.set_objective_function(objective)
    c.set_ineq_con_function(ineq)
    c.set_runtime_params({"v_pref": torch.zeros((B, 2), **kw)}, batched=True)
    c.set_optimizer_parameters(lt.NLParameters(**cfg["solver"]))
    buf = io.BytesIO()
    c.save_state(buf)
    cold = buf.getvalue()

    def before(x):
        v = goal[None, :] - x[:, 0:2]
        c.set_runtime_params(
            {"v_pref": v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                                       min=1e-9)}, batched=True)

    def plant(x, u, noise):
        x = x @ Ad.T + u @ Bd.T
        return x if noise is None else x + noise

    def keep(idx, x, u_prev, r):
        seq = c.get_optimal_sequence()
        return {"x": x[idx], "cmd": r.cmd[idx], "status": r.status[idx],
                "plan": seq.state[idx]}

    return System(controller=c, nx=nx, nu=nu, dtype=dtype, device=device,
                  reset=lambda: c.load_state(io.BytesIO(cold)), plant=plant, keep=keep,
                  before=before, success=int(lt.ResultStatus.SUCCESS))


def answers(cfg, samples, device, dtype=torch.float64, tf32=False):
    """The reference's moves at the kept states, its obstacle rows tangent
    at the kept positions, in ``dtype``: float64 for the check, the
    control's lower precision in the program's place."""
    ref = ugv_nlp.ObstacleMPC(cfg, device)
    f64 = lambda t: t.to(device=device, dtype=torch.float64)
    cmd, X, conv = ref.solve(f64(samples["x"]), f64(samples["plan"])[:, :, 0:2], dtype, tf32)
    return {"cmd": cmd, "plan": X, "converged": conv}


def residuals(cfg, samples, device):
    """Per lane: how far the plan's first predicted state lies from the
    model's step from the state under the served command (the dynamics the
    NLP holds as equalities)."""
    f64 = lambda t: t.to(device=device, dtype=torch.float64)
    Ad, Bd = ugv_nlp.zoh(f64(torch.tensor(cfg["A"])), f64(torch.tensor(cfg["B"])), cfg["ts"])
    step = f64(samples["x"]) @ Ad.T + f64(samples["cmd"]) @ Bd.T
    return {"dynamics_gap": (f64(samples["plan"])[:, 1] - step).abs().amax(dim=1)}

