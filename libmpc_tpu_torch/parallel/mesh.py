"""Process-group utilities for sharded fleets and the row-sharded QP.

Port of ``libmpc_tpu/parallel/mesh.py``.  The ranks of a
``torch.distributed`` process group, one process a device, are laid out as
a ``(data, model)`` mesh, the layout of JAX's ``grid.reshape(data, model)``:
rank ``r`` sits at data index ``r // model`` and model index ``r % model``.
Collectives (``all_reduce`` SUM/MAX, ``all_gather`` of rows) run over one
axis of the mesh, within the process group of the ranks that share the
other index, or over the whole mesh.

Axes, as in the JAX package:

* ``data`` — scenario/batch parallelism: the ranks at data index d hold rows
  ``[d*B/D, (d+1)*B/D)`` of a batch of B over D data indices, the layout of
  ``PartitionSpec("data")``.  The fleets reduce their statistics and gather
  their rows over this axis only.
* ``model`` — within-problem parallelism: the constraint rows of one QP
  split over the ranks of a model group (``parallel/qp_sharded.py``).

Launch one process a rank (``torchrun``, or ``torch.multiprocessing`` with
an explicit ``init_method``), call :func:`init_distributed` once in each,
then build the mesh.  The collectives run on the card with NCCL and on the
host with gloo (gloo reduces CUDA tensors but does not gather them, so a
gloo mesh moves host copies even when its ranks solve on a card).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import time
from typing import Any, Dict, Optional

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
    """This rank's place in the mesh: ``shape`` (``{"data": D, "model":
    M}``), ``rank``, the ``device`` its solves run on, the process group's
    ``backend`` (None without a process group: one rank, no collective) and
    ``groups``, the process group of each axis that has one (an axis absent
    from it spans the whole world, or has one rank)."""

    shape: Dict[str, int]
    rank: int
    device: torch.device
    backend: Optional[str]
    groups: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def size(self) -> int:
        """The data axis's size: the number of distinct batch shards."""
        return self.shape[DATA_AXIS]

    @property
    def data_index(self) -> int:
        return self.rank // self.shape[MODEL_AXIS]

    @property
    def model_index(self) -> int:
        return self.rank % self.shape[MODEL_AXIS]

    def rows(self, batch: int) -> slice:
        """This rank's rows of a batch of ``batch`` instances, by its data
        index; a batch that does not divide over the data axis raises
        ``ValueError`` (on every rank, before any collective)."""
        if batch % self.size:
            raise ValueError(f"batch {batch} must divide over data axis {self.size}")
        per = batch // self.size
        return slice(self.data_index * per, (self.data_index + 1) * per)

    def axis(self, name: Optional[str]) -> "Axis":
        """The :class:`Axis` ``name`` of this mesh, as the solver takes it
        (``ops/admm.py``'s ``axis_rows``/``axis_batch``); None: the whole
        mesh."""
        if name is not None and name not in self.shape:
            raise ValueError(f"mesh axes are {tuple(self.shape)}, not {name!r}")
        return Axis(self, name)


@dataclasses.dataclass(frozen=True)
class Axis:
    """One axis of a :class:`Mesh` (``name`` None: the whole mesh): the
    collectives of this rank over the ranks that share its other index.
    An axis of one rank reduces nothing and launches nothing.  Results come
    back on the input's device."""

    mesh: Mesh
    name: Optional[str]

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        return all_reduce(self.mesh, t, dist.ReduceOp.SUM, self.name).to(t.device)

    def max(self, t: torch.Tensor) -> torch.Tensor:
        return all_reduce(self.mesh, t, dist.ReduceOp.MAX, self.name).to(t.device)


def _axis_ranks(data: int, model: int):
    """The rank lists of each axis's groups, in the order every rank creates
    them: the model groups (one a data index), then the data groups (one a
    model index)."""
    return {
        MODEL_AXIS: [[d * model + j for j in range(model)] for d in range(data)],
        DATA_AXIS: [[d * model + j for d in range(data)] for j in range(model)],
    }


def make_mesh(data: Optional[int] = None, model: int = 1, device=None) -> Mesh:
    """This rank's :class:`Mesh` over the initialised process group (or a
    one-rank mesh without one).

    ``data`` defaults to ``world // model``, and ``data * model`` must equal
    the world size: every rank belongs to the mesh (the JAX package takes
    the first ``data * model`` devices; with one process a device, a rank
    left out would have no part in the collectives).  A shape that does not
    fit raises ``ValueError`` on every rank before any collective.  Every
    rank creates the axes' process groups in the same order
    (``dist.new_group`` is collective), also those it is not in; an axis
    that spans the world uses the world's group, and one of one rank none.

    ``device`` defaults to ``cuda:(local rank mod card count)``
    (``LOCAL_RANK``, else the rank), made the current CUDA device; pass
    ``device="cpu"`` to solve on the host.  Without a card and without
    ``device`` it raises, as the controllers do.
    """
    on = dist.is_initialized()
    world = dist.get_world_size() if on else 1
    rank = dist.get_rank() if on else 0
    backend = dist.get_backend() if on else None
    if model < 1:
        raise ValueError(f"mesh model={model} must be at least 1")
    if data is None:
        data = world // model
    if data < 1 or data * model != world:
        raise ValueError(f"mesh {data}x{model} needs {data * model} ranks, have {world}")
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
    groups = {}
    shape = {DATA_AXIS: data, MODEL_AXIS: model}
    for name, lists in _axis_ranks(data, model).items():
        if 1 < shape[name] < world:
            for ranks in lists:
                g = dist.new_group(ranks)
                if rank in ranks:
                    groups[name] = g
    return Mesh(shape, rank, device, backend, groups)


def shard_batch(mesh: Mesh, tree):
    """This rank's rows of every leaf of a pytree of batched arrays or
    tensors (leading axis split over ``data``)."""
    return tree_map(lambda a: a[mesh.rows(a.shape[0])], tree)


def pad_to_multiple(n: int, k: int) -> int:
    return ((n + k - 1) // k) * k


# -- collectives (none without a process group, or over an axis of one rank) --
def _on_wire(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """``t`` where the backend moves it: the rank's card for NCCL, the host
    for gloo."""
    return t.to(mesh.device if mesh.backend == "nccl" else "cpu")


def _group(mesh: Mesh, axis: Optional[str]):
    """(process group, ranks) of ``axis`` (None: the whole mesh); the group
    None is the world's."""
    if axis is None:
        return None, mesh.shape[DATA_AXIS] * mesh.shape[MODEL_AXIS]
    return mesh.groups.get(axis), mesh.shape[axis]


def _timed(fn, *args, **kw):
    """Run one collective, counted in ``all_reduce.calls`` and its host
    seconds in ``all_reduce.seconds`` (both kinds together)."""
    t0 = time.perf_counter()
    fn(*args, **kw)
    all_reduce.calls += 1
    all_reduce.seconds += time.perf_counter() - t0


def all_reduce(mesh: Mesh, t: torch.Tensor, op, axis: Optional[str] = DATA_AXIS) -> torch.Tensor:
    """``t`` reduced with ``op`` (a ``dist.ReduceOp``) over the ranks of
    ``axis`` that share this rank's other index (None: over the whole
    mesh), on the wire's device."""
    group, n = _group(mesh, axis)
    if mesh.backend is None or n == 1:
        return t
    t = _on_wire(mesh, t).contiguous()
    _timed(dist.all_reduce, t, op=op, group=group)
    return t


# collectives of either kind since the counts were last set to 0, and the
# host seconds spent in their calls (the device copies beside them excluded)
all_reduce.calls = 0
all_reduce.seconds = 0.0


def all_gather_rows(mesh: Mesh, t: torch.Tensor, axis: str = DATA_AXIS) -> torch.Tensor:
    """The ``t`` of every rank of ``axis`` that shares this rank's other
    index (the same shape on each), concatenated along the leading axis in
    the order of their index on ``axis``, on ``t``'s device."""
    group, n = _group(mesh, axis)
    if mesh.backend is None or n == 1:
        return t
    part = _on_wire(mesh, t).contiguous()
    if mesh.backend == "nccl":
        out = part.new_empty((n * part.shape[0],) + tuple(part.shape[1:]))
        _timed(dist.all_gather_into_tensor, out, part, group=group)
    else:
        parts = [torch.empty_like(part) for _ in range(n)]
        _timed(dist.all_gather, parts, part, group=group)
        out = torch.cat(parts)
    return out.to(t.device)


def barrier(mesh: Mesh) -> None:
    if mesh.backend == "nccl":
        dist.barrier(device_ids=[mesh.device.index])
    elif mesh.backend is not None:
        dist.barrier()
