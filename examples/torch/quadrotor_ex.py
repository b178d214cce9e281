"""Quadrotor linear MPC example (parity: examples/quadrotor_ex.cpp), on the
PyTorch/CUDA port.

12-state / 4-input discrete quadrotor regulation to an altitude reference,
ph = ch = 10, attitude/height state bounds and thrust input bounds around the
hover point.  One solve from the zero state prints the optimal command, the
optimal sequences and the execution stats, then a batched solve of 1024
randomized initial states in one call.

Run on the CUDA card:  python examples/torch/quadrotor_ex.py
(``main(device="cpu")`` runs it on the CPU.)
"""

import numpy as np

from libmpc_tpu_torch import LMPC, HorizonSlice, LogLevel, LParameters, inf


def build_controller(device=None, dtype=None):
    Tnx, Tnu, Tndu, Tny, Tph, Tch = 12, 4, 4, 12, 10, 10

    controller = LMPC(Tnx, Tnu, Tndu, Tny, Tph, Tch, dtype=dtype, device=device)
    controller.set_logger_level(LogLevel.NORMAL)

    Ad = np.array([
        [1, 0, 0, 0, 0, 0, 0.1, 0, 0, 0, 0, 0],
        [0, 1, 0, 0, 0, 0, 0, 0.1, 0, 0, 0, 0],
        [0, 0, 1, 0, 0, 0, 0, 0, 0.1, 0, 0, 0],
        [0.0488, 0, 0, 1, 0, 0, 0.0016, 0, 0, 0.0992, 0, 0],
        [0, -0.0488, 0, 0, 1, 0, 0, -0.0016, 0, 0, 0.0992, 0],
        [0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0.0992],
        [0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0],
        [0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0],
        [0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0],
        [0.9734, 0, 0, 0, 0, 0, 0.0488, 0, 0, 0.9846, 0, 0],
        [0, -0.9734, 0, 0, 0, 0, 0, -0.0488, 0, 0, 0.9846, 0],
        [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0.9846],
    ])
    Bd = np.array([
        [0, -0.0726, 0, 0.0726],
        [-0.0726, 0, 0.0726, 0],
        [-0.0152, 0.0152, -0.0152, 0.0152],
        [0, -0.0006, -0.0000, 0.0006],
        [0.0006, 0, -0.0006, 0],
        [0.0106, 0.0106, 0.0106, 0.0106],
        [0, -1.4512, 0, 1.4512],
        [-1.4512, 0, 1.4512, 0],
        [-0.3049, 0.3049, -0.3049, 0.3049],
        [0, -0.0236, 0, 0.0236],
        [0.0236, 0, -0.0236, 0],
        [0.2107, 0.2107, 0.2107, 0.2107],
    ])
    Cd = np.eye(12)
    controller.set_state_space_model(Ad, Bd, Cd)

    OutputW = np.array([0, 0, 10, 10, 10, 10, 0, 0, 0, 5, 5, 5], float)
    InputW = np.full(4, 0.1)
    DeltaInputW = np.zeros(4)
    controller.set_objective_weights(OutputW, InputW, DeltaInputW, HorizonSlice(0, Tph))

    xmin = np.array([-np.pi / 6, -np.pi / 6, -inf, -inf, -inf, -1,
                     -inf, -inf, -inf, -inf, -inf, -inf])
    xmax = np.array([np.pi / 6, np.pi / 6] + [inf] * 10)
    ymin = np.full(12, -inf)
    ymax = np.full(12, inf)
    u0 = 10.5916
    umin = np.full(4, 9.6) - u0
    umax = np.full(4, 13.0) - u0

    controller.set_state_bounds(xmin, xmax, HorizonSlice(0, Tph))
    controller.set_output_bounds(ymin, ymax, HorizonSlice(0, Tph))
    controller.set_input_bounds(umin, umax, HorizonSlice(0, Tch))

    controller.set_references(np.zeros((12, 10)), np.zeros((4, 10)), np.zeros((4, 10)))
    yRef = np.zeros(12)
    yRef[2] = 1.0
    controller.set_references(yRef, np.zeros(4), np.zeros(4), HorizonSlice(0, Tph))

    controller.set_optimizer_parameters(LParameters(maximum_iteration=250))
    return controller


def main(device=None, dtype=None):
    """Run the example; returns the single solve's result and the batched
    solve's result."""
    controller = build_controller(device, dtype)

    res = controller.optimize(np.zeros(12), np.zeros(4))
    seq = controller.get_optimal_sequence()

    print("Optimal control input:", res.cmd.cpu().numpy())
    print("Optimal sequence (input):\n", seq.input.cpu().numpy())
    print("Optimal sequence (output):\n", seq.output.cpu().numpy())
    print("Optimal sequence (state):\n", seq.state.cpu().numpy())
    print(controller.get_execution_stats())

    # beyond the reference: 1024 randomized starts in one solve
    rng = np.random.default_rng(0)
    x0s = 0.05 * rng.normal(size=(1024, 12))
    res_b = controller.optimize(x0s, np.zeros((1024, 4)))
    print("Batched solve: commands shape", tuple(res_b.cmd.shape),
          "all feasible:", bool(res_b.is_feasible.all()))
    return res, res_b


if __name__ == "__main__":
    main()
