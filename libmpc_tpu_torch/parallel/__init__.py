"""Batch-sharded fleets and the row-sharded QP over ``torch.distributed``
(port of ``libmpc_tpu/parallel/``: a ``(data, model)`` mesh of ranks).

Public surface re-exported here so users can write::

    from libmpc_tpu_torch.parallel import init_distributed, make_mesh, LMPCFleet
    from libmpc_tpu_torch.parallel import solve_sharded
"""

from .mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    init_distributed,
    make_mesh,
    shard_batch,
)
from .fleet import FleetStats, LMPCFleet, NLMPCFleet  # noqa: F401
from .qp_sharded import ShardedQPSolution, solve_sharded  # noqa: F401

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "FleetStats",
    "LMPCFleet",
    "Mesh",
    "NLMPCFleet",
    "ShardedQPSolution",
    "init_distributed",
    "make_mesh",
    "shard_batch",
    "solve_sharded",
]
