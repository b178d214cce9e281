"""Fleet example, on the PyTorch/CUDA port.

No reference counterpart: one quadrotor controller configuration, a fleet of
randomized scenarios solved in lockstep over the ranks of a process group,
with per-instance references and bounds, fleet statistics aggregated by
collectives, and a closed-loop rollout on the card.

Run as one process on one card:  python examples/torch/fleet_ex.py
or one process a card:           torchrun --nproc-per-node 4 examples/torch/fleet_ex.py
"""

import numpy as np

from libmpc_tpu_torch import LParameters
from libmpc_tpu_torch.parallel.fleet import LMPCFleet
from libmpc_tpu_torch.parallel.mesh import init_distributed, make_mesh
from libmpc_tpu_torch.rollout import lmpc_rollout

from quadrotor_ex import build_controller


def main(device=None, dtype=None):
    """Solve the fleet and roll it out; returns (fleet result, fleet stats,
    rollout)."""
    init_distributed()
    mesh = make_mesh(device=device)
    n_ranks = mesh.size
    print(f"mesh: {mesh.shape} over {mesh.device}")

    controller = build_controller(mesh.device, dtype)
    controller.set_optimizer_parameters(
        LParameters(maximum_iteration=250, enable_warm_start=True, polish=False)
    )
    fleet = LMPCFleet(controller, mesh)

    B = 16 * n_ranks
    rng = np.random.default_rng(0)
    x0 = 0.05 * rng.normal(size=(B, 12))
    u0 = np.zeros((B, 4))

    # per-instance altitude references
    y_ref = np.zeros((B, 10, 12))
    y_ref[:, :, 2] = rng.uniform(0.5, 1.5, size=(B, 1))

    result, stats = fleet.optimize(x0, u0, y_ref=y_ref)
    print(stats)

    # closed loop on the card for the same fleet (shared reference here)
    Ad = controller._prob.ssA[:12, :12]
    Bd = controller._prob.ssB[:12, :]
    plant = lambda x, u, k: x @ Ad.T + u @ Bd.T
    roll = lmpc_rollout(controller, plant, x0, u0, n_steps=40)
    final_alt = roll.states[:, -1, 2].cpu().numpy()
    print(f"rollout: {B} instances x 40 steps, "
          f"altitude mean {final_alt.mean():.3f} "
          f"(target 1.0), all-success={bool((roll.statuses == 0).all())}")
    return result, stats, roll


if __name__ == "__main__":
    main()
