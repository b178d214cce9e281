"""Van der Pol nonlinear MPC example (parity: examples/vanderpol_ex.cpp), on
the PyTorch/CUDA port.

2-state continuous-time Van der Pol oscillator regulated to the origin,
ph = 10, ch = 5, with the per-step input cap ``u <= 0.5`` as a user
inequality constraint; closed loop with explicit-Euler plant updates until
the state reaches the origin tolerance.

Run on the CUDA card:  python examples/torch/vanderpol_ex.py
"""

import numpy as np
import torch

from libmpc_tpu_torch import NLMPC, LogLevel, NLParameters


def state_eq(x, u, k):
    return torch.stack([
        (1.0 - x[1] * x[1]) * x[0] - x[1] + u[0],
        x[0],
    ])


def main(device=None, dtype=None):
    """Run the closed loop until the state reaches the origin tolerance (at
    most 500 steps); returns (steps, final state, commands applied)."""
    num_states, num_inputs, num_output = 2, 1, 2
    pred_hor, ctrl_hor = 10, 5
    ineq_c, eq_c = pred_hor + 1, 0
    ts = 0.1

    controller = NLMPC(num_states, num_inputs, num_output,
                       pred_hor, ctrl_hor, ineq_c, eq_c, dtype=dtype, device=device)
    controller.set_logger_level(LogLevel.NONE)
    controller.set_discretization_sampling_time(ts)
    controller.set_optimizer_parameters(NLParameters(maximum_iteration=1000))

    controller.set_state_space_function(state_eq)
    controller.set_objective_function(
        lambda X, Y, U, e: torch.sum(X**2) + torch.sum(U**2)
    )
    controller.set_ineq_con_function(lambda X, Y, U, e: U[:, 0] - 0.5)

    model_x = np.array([0.0, 1.0])
    cmd = np.zeros(num_inputs)
    cmds = []

    for step in range(500):
        res = controller.optimize(model_x, cmd)
        cmd = res.cmd.cpu().numpy().astype(float)
        cmds.append(cmd)
        dx = state_eq(torch.as_tensor(model_x), torch.as_tensor(cmd), 0).numpy()
        model_x = model_x + dx * ts
        if abs(model_x[0]) <= 1e-2 and abs(model_x[1]) <= 1e-1:
            break

    print(f"converged in {step + 1} steps, final state {model_x}")
    print(controller.get_execution_stats())
    return step + 1, model_x, np.array(cmds)


if __name__ == "__main__":
    main()
