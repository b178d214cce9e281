"""Process-group utilities for batch-sharded fleets.

Port of ``libmpc_tpu/parallel/mesh.py``.  The scaling axis is the *batch of
problem instances*: a fleet of MPC problems is split over the ranks of a
``torch.distributed`` process group, one rank a process and a device, each
rank solving its contiguous slice of the batch, with ``all_reduce``
(SUM, MAX) collectives for the fleet-level statistics and an
``all_gather`` of the result rows.  This module holds the rank layout
shared by the fleet solvers and the collectives they use.

Axes, as in the JAX package:

* ``data`` — scenario/batch parallelism: rank r holds rows
  ``[r*B/R, (r+1)*B/R)`` of a batch of B over R ranks, the layout of
  ``PartitionSpec("data")``.
* ``model`` — within-problem parallelism (the row-sharded QP).  Not ported:
  :func:`make_mesh` refuses ``model > 1``.

Launch one process a rank (``torchrun``, or ``torch.multiprocessing`` with
an explicit ``init_method``), call :func:`init_distributed` once in each,
then build the mesh.  The collectives run on the card with NCCL and on the
host with gloo (gloo reduces CUDA tensors but does not gather them, so a
gloo mesh gathers host copies even when its ranks solve on a card).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_map

DATA_AXIS = "data"
MODEL_AXIS = "model"


def init_distributed(init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     backend: Optional[str] = None,
                     timeout=None) -> None:
    """Join this process to the fleet's process group.

    A no-op when the group is already initialised, or when this is the one
    process and nothing is asked (no argument, no ``WORLD_SIZE`` above 1 in
    the environment).  Wraps ``torch.distributed.init_process_group``:
    ``init_method`` defaults to ``env://`` (what ``torchrun`` sets up),
    ``backend`` to NCCL where a CUDA card is present and gloo otherwise, and
    ``timeout`` (seconds or a ``timedelta``) bounds every collective, so a
    rank whose peer died raises instead of waiting forever.
    """
    if dist.is_initialized():
        return
    asked = init_method is not None or world_size is not None or rank is not None
    if not asked and int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if timeout is not None and not isinstance(timeout, datetime.timedelta):
        timeout = datetime.timedelta(seconds=float(timeout))
    dist.init_process_group(
        backend, init_method=init_method, timeout=timeout,
        world_size=-1 if world_size is None else int(world_size),
        rank=-1 if rank is None else int(rank),
    )


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in the fleet: ``shape`` (``{"data": R, "model":
    1}``), ``rank``, the ``device`` its solves run on and the process
    group's ``backend`` (None without a process group: one rank, no
    collective)."""

    shape: Dict[str, int]
    rank: int
    device: torch.device
    backend: Optional[str]

    @property
    def size(self) -> int:
        return self.shape[DATA_AXIS]

    def rows(self, batch: int) -> slice:
        """This rank's rows of a batch of ``batch`` instances; a batch that
        does not divide over the ranks raises ``ValueError`` (on every rank,
        before any collective)."""
        if batch % self.size:
            raise ValueError(f"batch {batch} must divide over data axis {self.size}")
        per = batch // self.size
        return slice(self.rank * per, (self.rank + 1) * per)


def make_mesh(data: Optional[int] = None, model: int = 1, device=None) -> Mesh:
    """This rank's :class:`Mesh` over the initialised process group (or a
    one-rank mesh without one).

    ``data`` defaults to the world size and must equal it.  ``device``
    defaults to ``cuda:(local rank mod card count)`` (``LOCAL_RANK``, else
    the rank), made the current CUDA device; pass ``device="cpu"`` to solve
    on the host.  Without a card and without ``device`` it raises, as the
    controllers do.
    """
    if model != 1:
        raise NotImplementedError(
            "model > 1 is the row-sharded QP (parallel/qp_sharded.py), not "
            "ported yet (ROADMAP.md queue 1 item 2)"
        )
    on = dist.is_initialized()
    world = dist.get_world_size() if on else 1
    rank = dist.get_rank() if on else 0
    backend = dist.get_backend() if on else None
    if data is None:
        data = world
    if data != world:
        raise ValueError(f"mesh data={data} needs {data} ranks, have {world}")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh places the rank on a CUDA device by default and "
                "torch.cuda.is_available() is False; pass device=\"cpu\""
            )
        local = int(os.environ.get("LOCAL_RANK", rank))
        device = torch.device("cuda", local % torch.cuda.device_count())
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("an NCCL process group needs a CUDA device for its ranks")
    return Mesh({DATA_AXIS: data, MODEL_AXIS: 1}, rank, device, backend)


def shard_batch(mesh: Mesh, tree):
    """This rank's rows of every leaf of a pytree of batched arrays or
    tensors (leading axis split over ``data``)."""
    return tree_map(lambda a: a[mesh.rows(a.shape[0])], tree)


def pad_to_multiple(n: int, k: int) -> int:
    return ((n + k - 1) // k) * k


# -- collectives (none without a process group) --------------------------------
def _on_wire(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """``t`` where the backend moves it: the rank's card for NCCL, the host
    for gloo."""
    return t.to(mesh.device if mesh.backend == "nccl" else "cpu")


def all_reduce(mesh: Mesh, t: torch.Tensor, op) -> torch.Tensor:
    """``t`` reduced over the ranks with ``op`` (a ``dist.ReduceOp``), on
    the wire's device."""
    if mesh.backend is None:
        return t
    t = _on_wire(mesh, t).contiguous()
    dist.all_reduce(t, op=op)
    return t


def all_gather_rows(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` (the same shape on each) concatenated along the
    leading axis in rank order, on ``t``'s device."""
    if mesh.backend is None:
        return t
    part = _on_wire(mesh, t).contiguous()
    if mesh.backend == "nccl":
        out = part.new_empty((mesh.size * part.shape[0],) + tuple(part.shape[1:]))
        dist.all_gather_into_tensor(out, part)
    else:
        parts = [torch.empty_like(part) for _ in range(mesh.size)]
        dist.all_gather(parts, part)
        out = torch.cat(parts)
    return out.to(t.device)


def barrier(mesh: Mesh) -> None:
    if mesh.backend == "nccl":
        dist.barrier(device_ids=[mesh.device.index])
    elif mesh.backend is not None:
        dist.barrier()
