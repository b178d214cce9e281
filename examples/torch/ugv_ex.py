"""UGV obstacle-avoidance nonlinear MPC example (parity: examples/ugv_ex.cpp),
on the PyTorch/CUDA port.

4-state double-integrator unmanned ground vehicle tracking a velocity
reference toward a goal while avoiding two circular obstacles, expressed as
``r - ||p - p_obs||  <= 0`` inequalities over the horizon; soft constraints
and warm start enabled, 150-step closed loop.

Run on the CUDA card:  python examples/torch/ugv_ex.py
"""

import numpy as np
import torch

from libmpc_tpu_torch import NLMPC, LogLevel, NLParameters, discretization


def main(device=None, dtype=None):
    """Run the closed loop until the goal is reached (at most 150 steps);
    returns (positions visited, obstacles, radii, goal)."""
    n_obs = 2
    Tnx, Tnu, Tny = 4, 2, 4
    Tph, Tch = 10, 10
    Tineq, Teq = (Tph + 1) * n_obs, 0
    Ts = 0.1

    controller = NLMPC(Tnx, Tnu, Tny, Tph, Tch, Tineq, Teq, dtype=dtype, device=device)
    controller.set_logger_level(LogLevel.NORMAL)

    # double integrator: p' = v, v' = u / m
    A = np.zeros((4, 4))
    A[0:2, 2:4] = np.eye(2)
    B = np.zeros((4, 2))
    B[2:4, 0:2] = np.eye(2)
    Ad, Bd = (t.numpy() for t in discretization(A, B, Ts))

    # constants the callbacks use live on the controller's device
    on_device = lambda a: torch.as_tensor(a, dtype=controller.dtype,
                                          device=controller.device)
    Ad_t = on_device(Ad)
    Bd_t = on_device(Bd)

    controller.set_state_space_function(lambda x, u, k: Ad_t @ x + Bd_t @ u)
    controller.set_output_function(lambda x, u, k: x)

    obstacles = np.array([[2.0, 1.0], [1.0, 1.0]])
    radii = np.array([0.3, 0.3])
    obstacles_t = on_device(obstacles)
    radii_t = on_device(radii)
    speed = 1.0
    yref = np.array([2.0, 2.0])

    # the preferred velocity changes every loop step; it flows through the
    # runtime-parameter channel (trailing `p` argument), so each step is a
    # pure data update of the configured controller (the reference's C++
    # lambdas capture it by reference instead, ugv_ex.cpp:79-96)
    def objective(X, Y, U, e, p):
        v_err = X[:, 2:4] - p["v_pref"][None, :]
        cost = 1e3 * torch.sum(v_err**2) + 1e-2 * torch.sum(U**2)
        return cost + 1e-5 * e * e

    def ineq(X, Y, U, e):
        # r - ||p - p_obs|| <= 0 for every horizon row and obstacle
        pos = X[:, 0:2]  # (ph+1, 2)
        d = torch.sqrt(
            torch.sum((pos[:, None, :] - obstacles_t[None, :, :]) ** 2, dim=-1)
        )
        return (radii_t[None, :] - d).reshape(-1)

    controller.set_objective_function(objective)
    controller.set_ineq_con_function(ineq)
    controller.set_runtime_params({"v_pref": torch.zeros(2)})

    # single-instance run: the defaults are fine.  For float32 FLEET runs of
    # this nonconvex family use the production configuration
    # (hessian_reg="eigh", inner_qp="admm", cold_restart_on_failure=True).
    controller.set_optimizer_parameters(
        NLParameters(
            maximum_iteration=100,
            relative_ftol=-1,
            relative_xtol=-1,
            hard_constraints=False,
            enable_warm_start=True,
        )
    )

    m_x = np.zeros(4)
    cmd = np.zeros(2)
    traj = [m_x[0:2].copy()]

    t = 0.0
    for i in range(150):
        v = yref - m_x[0:2]
        v = v / max(np.linalg.norm(v), 1e-9) * speed
        controller.set_runtime_params({"v_pref": v})

        res = controller.optimize(m_x, cmd)
        cmd = res.cmd.cpu().numpy().astype(float)
        m_x = Ad @ m_x + Bd @ cmd
        traj.append(m_x[0:2].copy())
        t += Ts

        print(f"{t:.1f}, pos=({m_x[0]:.3f}, {m_x[1]:.3f}), "
              f"cmd=({cmd[0]:.3f}, {cmd[1]:.3f}), cost={float(res.cost):.3f}")

        if np.linalg.norm(m_x[0:2] - yref) < 0.05:
            break

    print(controller.get_execution_stats())
    if np.linalg.norm(m_x[0:2] - yref) >= 0.05:
        raise RuntimeError(f"goal not reached: {m_x[0:2]}")
    print("goal reached at t =", round(t, 2), "s")
    return np.array(traj), obstacles, radii, yref


if __name__ == "__main__":
    main()
