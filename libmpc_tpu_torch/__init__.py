"""libmpc_tpu_torch: the PyTorch and CUDA port of libmpc-tpu.

Linear MPC over a sparse simultaneous QP, solved by a batched
OSQP-equivalent ADMM solver whose iteration blocks and polish capacitance
inverses run in hand-written CUDA kernels on an NVIDIA H100 (float32 or
float64), and in plain PyTorch on the CPU.  The JAX package ``libmpc_tpu``
is the reference this port is held against; this package imports neither
it nor JAX.  Not ported yet: NLMPC, rollouts, fleets, checkpoints and the
compatibility surface.
"""

from .dims import LDims, NLDims
from .lmpc.controller import LMPC
from .types import (
    ConstraintsType,
    HorizonSlice,
    LParameters,
    NLParameters,
    OptSequence,
    Parameters,
    Result,
    ResultStatus,
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
    "default_dtype",
    "set_default_dtype",
]
