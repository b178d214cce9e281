"""Production-serving example: deadlines, lazy stats, checkpoint, failures,
on the PyTorch/CUDA port.

Runs a quadrotor LMPC fleet the way a serving deployment would, exercising
the operational features together (no reference counterpart; the reference
is a single-process library):

* ``time_limit``: a per-solve deadline enforced as a measured-cost
  iteration budget; deadline-stopped solves return the reference's
  time-limit status with the partial iterate;
* lazy execution stats: ``optimize`` records the statuses without reading
  them back each step; they resolve in one stacked read when the stats are
  read;
* checkpoint / resume: the warm-start state snapshots to disk mid-run and a
  fresh fleet resumes from it bit-identically;
* failure containment: one instance's state estimate turns NaN mid-run;
  that instance holds its last command (ResultStatus.ERROR) while the rest
  of the fleet keeps solving.

Run as one process on one card:  python examples/torch/serving_ex.py
or one process a card:           torchrun --nproc-per-node 4 examples/torch/serving_ex.py
"""

import os
import shutil
import tempfile

import numpy as np
import torch.distributed as dist

from libmpc_tpu_torch import LParameters, ResultStatus
from libmpc_tpu_torch.parallel.fleet import LMPCFleet
from libmpc_tpu_torch.parallel.mesh import init_distributed, make_mesh
from libmpc_tpu_torch.utils import checkpoint

from quadrotor_ex import build_controller


def main(device=None, dtype=None):
    """Serve 12 steps, then resume from the checkpoint; returns (last
    result, the command instance 3 held, resumed result)."""
    init_distributed()
    mesh = make_mesh(device=device)
    n_ranks = mesh.size
    controller = build_controller(mesh.device, dtype)
    controller.set_optimizer_parameters(LParameters(
        maximum_iteration=100, enable_warm_start=True,
        polish=True, polish_mode="shared", rho=0.01,
        time_limit=5.0,            # generous per-solve deadline: the
        # budget machinery runs (calibration, iteration cap) without
        # deadline-stopping healthy instances on slow hosts
    ))
    controller.set_stats_mode("lazy")
    fleet = LMPCFleet(controller, mesh)

    B = 8 * n_ranks
    rng = np.random.default_rng(0)
    x = 0.03 * rng.normal(size=(B, 12))
    u = np.zeros((B, 4))

    # rank 0 picks the checkpoint's directory; every rank reads the file
    where = [tempfile.mkdtemp() if mesh.rank == 0 else None]
    if dist.is_initialized():
        dist.broadcast_object_list(where, src=0)
    ckpt = os.path.join(where[0], "fleet_state.npz")
    for step in range(12):
        result, stats = fleet.optimize(x, u)
        u = result.cmd.cpu().numpy()
        # plant step: double-integrator-ish decay toward the setpoint
        x = 0.9 * x + 0.05 * rng.normal(size=x.shape) * 0.01
        if step == 5:
            checkpoint.save_fleet(fleet, ckpt)
            print(f"[step {step}] checkpointed warm state -> {ckpt}")
        if step == 8:
            held = u[3].copy()
            x[3] = np.nan  # instance 3's estimator fails
    statuses = result.status.cpu().numpy()
    print(f"instance 3 status: {ResultStatus(int(statuses[3])).name} "
          f"(holds last command, |cmd|={np.abs(u[3]).max():.3f})")
    counts = {ResultStatus(s).name: int((statuses == s).sum()) for s in np.unique(statuses)}
    print(f"fleet statuses: {counts}")
    print(stats)

    # resume from the checkpoint in a brand-new fleet
    fleet2 = LMPCFleet(controller, mesh)
    checkpoint.load_fleet(fleet2, ckpt)
    r2, _ = fleet2.optimize(np.nan_to_num(x), u)
    print(f"resumed fleet solved: "
          f"{int((r2.status == 0).sum())}/{B} SUCCESS")
    if mesh.rank == 0:  # every rank has read the file: the resumed step's collectives ran
        shutil.rmtree(where[0])
    return result, held, r2


if __name__ == "__main__":
    main()
