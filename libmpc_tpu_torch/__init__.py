"""libmpc_tpu_torch: the PyTorch and CUDA port of libmpc-tpu.

Linear MPC over a sparse simultaneous QP, solved by a batched
OSQP-equivalent ADMM solver, and nonlinear MPC by a batched SQP with exact
``torch.func`` derivatives whose inner QPs go to a fused ADMM solve or, for
large trajectory problems, to a banded-KKT interior point.  The ADMM
iteration blocks, the small SPD inverses, the whole inner-QP solves and the
banded factorization and solve sweeps run in hand-written CUDA kernels on an
NVIDIA H100 (float32 or float64), and in plain PyTorch on the CPU.
Controllers run on the CUDA card unless built with ``device="cpu"``.
The JAX package ``libmpc_tpu`` is the reference this port is held against;
this package imports neither it nor JAX.  Over the ranks of a
``torch.distributed`` process group laid out as a ``(data, model)`` mesh
(``parallel/``), fleets split a batch and ``solve_sharded`` splits one QP's
constraint rows.  ``compat`` is the drop-in surface of the reference's
pympcxx binding, ``native_qp`` binds the independent C++ QP oracle the
solver is tested against, and ``utils/flops.py`` holds the analytic FLOP
and byte models; ``examples/torch/`` has the six examples.
"""

from .dims import LDims, NLDims
from .lmpc.controller import LMPC
from .nlmpc.controller import NLMPC
from .rollout import Rollout, lmpc_rollout, nlmpc_rollout
from .types import (
    ConstraintsType,
    HorizonSlice,
    LParameters,
    NLParameters,
    OptSequence,
    Parameters,
    Result,
    ResultStatus,
    default_device,
    default_dtype,
    inf,
    set_default_dtype,
)
from .utils.discretization import (
    discretization,
    discretization_with_disturbance,
    discretization_with_output,
)
from .utils.integrators import rk4, rk4_step
from .utils.logger import Logger, LogLevel, LogType
from .utils.profiler import Profiler, SolutionStats

__version__ = "0.5.0"

__all__ = [
    "LMPC",
    "NLMPC",
    "Rollout",
    "lmpc_rollout",
    "nlmpc_rollout",
    "LDims",
    "NLDims",
    "HorizonSlice",
    "ResultStatus",
    "ConstraintsType",
    "Parameters",
    "LParameters",
    "NLParameters",
    "Result",
    "OptSequence",
    "Logger",
    "LogLevel",
    "LogType",
    "Profiler",
    "SolutionStats",
    "discretization",
    "discretization_with_disturbance",
    "discretization_with_output",
    "rk4",
    "rk4_step",
    "inf",
    "default_device",
    "default_dtype",
    "set_default_dtype",
]

# the fleets and the sharded QP import torch.distributed, so they load on
# first use
_LAZY = {
    "LMPCFleet": ("libmpc_tpu_torch.parallel.fleet", "LMPCFleet"),
    "NLMPCFleet": ("libmpc_tpu_torch.parallel.fleet", "NLMPCFleet"),
    "FleetStats": ("libmpc_tpu_torch.parallel.fleet", "FleetStats"),
    "make_mesh": ("libmpc_tpu_torch.parallel.mesh", "make_mesh"),
    "init_distributed": ("libmpc_tpu_torch.parallel.mesh", "init_distributed"),
    "solve_sharded": ("libmpc_tpu_torch.parallel.qp_sharded", "solve_sharded"),
}

__all__ += list(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
