"""Batch-sharded fleets over ``torch.distributed`` (port of
``libmpc_tpu/parallel/``, its ``data`` axis).

Public surface re-exported here so users can write::

    from libmpc_tpu_torch.parallel import init_distributed, make_mesh, LMPCFleet
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

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "FleetStats",
    "LMPCFleet",
    "Mesh",
    "NLMPCFleet",
    "init_distributed",
    "make_mesh",
    "shard_batch",
]
