"""Networked Van der Pol oscillators NLMPC example
(parity: examples/networked_oscillators_ex.cpp), on the PyTorch/CUDA port.

6 diffusively-coupled Van der Pol oscillators -> 12 states / 6 inputs,
ph = 20, ch = 10, with the per-entry input cap ``u <= 0.5``; 10-step
closed loop from one excited oscillator.

Run on the CUDA card:  python examples/torch/networked_oscillators_ex.py
"""

import numpy as np
import torch

from libmpc_tpu_torch import NLMPC, LogLevel, NLParameters

N = 6
num_states = 2 * N
num_output = 2 * N
num_inputs = N
pred_hor = 20
ctrl_hor = 10
ineq_c = (pred_hor + 1) * num_inputs
eq_c = 0
ts = 0.1
mu = 1.0
k = 0.1


def oscillator_network_dynamics(x, u, step):
    pos = x[0::2]  # (N,)
    vel = x[1::2]
    coupling = k * (torch.sum(pos) - N * pos)  # sum_j (x_j - x_i), vectorized
    dvel = mu * (1.0 - pos**2) * vel - pos + u + coupling
    # interleave (vel_i, dvel_i) without writing into a tensor, so torch.func
    # can differentiate it
    return torch.stack((vel, dvel), -1).reshape(-1)


def main(device=None, dtype=None):
    """Run the 10-step closed loop; returns (steps, initial state, final
    state, commands applied)."""
    controller = NLMPC(num_states, num_inputs, num_output,
                       pred_hor, ctrl_hor, ineq_c, eq_c, dtype=dtype, device=device)
    controller.set_logger_level(LogLevel.NONE)
    controller.set_discretization_sampling_time(ts)
    controller.set_state_space_function(oscillator_network_dynamics)
    controller.set_objective_function(
        lambda X, Y, U, e: torch.sum(X**2) + torch.sum(U**2)
    )
    controller.set_ineq_con_function(lambda X, Y, U, e: (U - 0.5).reshape(-1))
    controller.set_optimizer_parameters(NLParameters(maximum_iteration=100))

    model_x = np.zeros(num_states)
    model_x[0] = 1.0  # initial condition for one of the oscillators
    x_start = model_x.copy()
    cmd = np.zeros(num_inputs)
    cmds = []

    for step in range(10):
        res = controller.optimize(model_x, cmd)
        cmd = res.cmd.cpu().numpy().astype(float)
        cmds.append(cmd)
        dx = oscillator_network_dynamics(
            torch.as_tensor(model_x), torch.as_tensor(cmd), 0).numpy()
        model_x = model_x + dx * ts
        if np.abs(model_x).max() < 1e-2:
            break

    print(f"after {step + 1} steps, max |x| = {np.abs(model_x).max():.4f}")
    print(controller.get_execution_stats())
    return step + 1, x_start, model_x, np.array(cmds)


if __name__ == "__main__":
    main()
