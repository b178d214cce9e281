"""The quadrotor LMPC: the controller, the plant and the check.

Builds ``libmpc_tpu_torch.LMPC`` from ``quadrotor-lmpc.json`` as
``examples/quadrotor_ex.cpp`` of libmpc++ sets it up, with the production
closed-loop solver settings the file names.  The plant is the model itself,
``x+ = Ad x + Bd u`` plus the traffic's process noise.

Cold start: a controller's first ``optimize`` is cold, and no public call
resets the warm start.  The builder therefore gives the fresh controller a
warm start of another batch shape (one unbatched zero vector, which a
batched ``optimize`` never uses), saves that state with ``save_state`` into
memory, and every episode begins with ``load_state`` of it.

The check (``mpcbench/check.py``): on the kept lane-steps whose status is
SUCCESS, the served command against the plain reference's
(``reference/lmpc_qp.py``, float64).
"""

from __future__ import annotations

import io

import numpy as np
import torch

from mpcbench.loop import System
from mpcbench.reference import lmpc_qp


def _vec(v, missing):
    return np.array([missing if x is None else x for x in v], float)


def bounds(cfg):
    """(state_min, state_max, input_min, input_max), ``None`` (no bound) as
    an infinity."""
    return (_vec(cfg["state_min"], -np.inf), _vec(cfg["state_max"], np.inf),
            _vec(cfg["input_min"], -np.inf), _vec(cfg["input_max"], np.inf))


def build(cfg, traffic, device) -> System:
    import libmpc_tpu_torch as lt

    dtype = getattr(torch, cfg["dtype"])
    nx, nu, ph = cfg["nx"], cfg["nu"], cfg["ph"]
    c = lt.LMPC(nx, nu, cfg["ndu"], cfg["ny"], ph, cfg["ch"], dtype=dtype, device=device)
    Ad, Bd = np.array(cfg["Ad"]), np.array(cfg["Bd"])
    c.set_state_space_model(Ad, Bd, np.array(cfg["C"]))
    c.set_disturbances(np.zeros((nx, cfg["ndu"])), np.zeros((cfg["ny"], cfg["ndu"])))
    horizon = lt.HorizonSlice(0, ph)
    c.set_objective_weights(np.array(cfg["output_weight"], float),
                            np.array(cfg["input_weight"], float),
                            np.array(cfg["delta_input_weight"], float), horizon)
    xmin, xmax, umin, umax = bounds(cfg)
    c.set_state_bounds(xmin, xmax, horizon)
    c.set_input_bounds(umin, umax, horizon)
    c.set_references(np.array(cfg["output_reference"], float), np.zeros(nu), np.zeros(nu),
                     horizon)
    c.set_optimizer_parameters(lt.LParameters(**cfg["solver"]))
    c.set_solver_warm_start(np.zeros(cfg["qp_n"]), np.zeros(cfg["qp_m"]))
    buf = io.BytesIO()
    c.save_state(buf)
    cold = buf.getvalue()

    Ad_t = torch.as_tensor(Ad, dtype=dtype, device=device)
    Bd_t = torch.as_tensor(Bd, dtype=dtype, device=device)

    def plant(x, u, noise):
        x = x @ Ad_t.T + u @ Bd_t.T
        return x if noise is None else x + noise

    def keep(idx, x, u_prev, r):
        return {"x": x[idx], "u_prev": u_prev[idx], "cmd": r.cmd[idx],
                "status": r.status[idx]}

    return System(controller=c, nx=nx, nu=nu, dtype=dtype, device=device,
                  reset=lambda: c.load_state(io.BytesIO(cold)), plant=plant, keep=keep,
                  success=int(lt.ResultStatus.SUCCESS))


def answers(cfg, samples, device, dtype=torch.float64, tf32=False):
    """The reference's commands at the kept states, in ``dtype``: float64
    for the check, the control's lower precision for its reading."""
    ref = lmpc_qp.LinearMPC(cfg, device)
    f64 = lambda t: t.to(device=device, dtype=torch.float64)
    cmd, conv = ref.commands(f64(samples["x"]), f64(samples["u_prev"]), dtype, tf32)
    return {"cmd": cmd, "converged": conv}

