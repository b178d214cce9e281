"""Checkpoint / resume for controllers.

Port of ``libmpc_tpu/utils/checkpoint.py``.  The reference's only persistent
solver state is the warm start: OSQP primal/dual vectors for LMPC
(reference: include/mpc/LMPC.hpp:677-722) and the shifted ``opt_vector`` for
NLMPC (NLOptimizer.hpp:426-507).  This module snapshots that state — plus
enough metadata to refuse a mismatched restore — to a single ``.npz`` file,
so a long closed loop can resume mid-trajectory.

The file is the JAX package's: the same array names and the same
``__meta__`` JSON, so a file either package writes loads into the other.
Tensors are copied to the host as numpy arrays on save and onto the
controller's device, in its dtype, on load.  ``save_fleet`` /
``load_fleet`` write and read the whole fleet's arrays, whatever the number
of ranks that saves or loads them.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict

import numpy as np
import torch


def _host(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def save_pytree(path: str, tree: Dict[str, Any], meta: Dict[str, Any]) -> None:
    """Save a flat dict of arrays or tensors (None values skipped) with JSON
    metadata."""
    arrays = {k: _host(v) for k, v in tree.items() if v is not None}
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez(path, **arrays)


def load_pytree(path: str) -> tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    data = np.load(path, allow_pickle=False)
    meta = json.loads(bytes(data["__meta__"].tobytes()).decode())
    arrays = {k: data[k] for k in data.files if k != "__meta__"}
    return arrays, meta


def check_meta(meta: Dict[str, Any], expected: Dict[str, Any]) -> None:
    for key, val in expected.items():
        if meta.get(key) != val:
            raise ValueError(
                f"checkpoint mismatch on {key!r}: saved {meta.get(key)!r}, "
                f"expected {val!r}"
            )


def _tensor(controller, a) -> torch.Tensor:
    return torch.as_tensor(a, dtype=controller.dtype, device=controller.device)


def _restore_cmd(controller, arrays) -> None:
    if "last_cmd" in arrays:
        controller._result = dataclasses.replace(
            controller._result, cmd=_tensor(controller, arrays["last_cmd"]))


# ---------------------------------------------------------------------------
# controller-level helpers
# ---------------------------------------------------------------------------

def save_lmpc(controller, path: str) -> None:
    """Snapshot an LMPC controller's warm-start state and last command."""
    tree = {
        "warm_x": controller._warm_x,
        "warm_y": controller._warm_y,
        "last_cmd": controller._result.cmd,
    }
    meta = {"kind": "lmpc", "dims": list(controller.dims)}
    save_pytree(path, tree, meta)


def load_lmpc(controller, path: str) -> None:
    arrays, meta = load_pytree(path)
    check_meta(meta, {"kind": "lmpc", "dims": list(controller.dims)})
    if "warm_x" in arrays:
        controller._warm_x = _tensor(controller, arrays["warm_x"])
    if "warm_y" in arrays:
        controller._warm_y = _tensor(controller, arrays["warm_y"])
    _restore_cmd(controller, arrays)


def save_nlmpc(controller, path: str) -> None:
    """Snapshot an NLMPC controller's warm-start state and last command."""
    tree = {
        "opt_vector": controller._opt_vector,
        "current_slack": _host(controller._current_slack),
        "last_cmd": controller._result.cmd,
    }
    meta = {
        "kind": "nlmpc",
        "dims": list(controller.dims),
        "first_iteration": bool(controller._first_iteration),
    }
    save_pytree(path, tree, meta)


def load_nlmpc(controller, path: str) -> None:
    arrays, meta = load_pytree(path)
    check_meta(meta, {"kind": "nlmpc", "dims": list(controller.dims)})
    if "opt_vector" in arrays:
        controller._opt_vector = _tensor(controller, arrays["opt_vector"])
    if "current_slack" in arrays:
        controller._current_slack = _tensor(controller, arrays["current_slack"])
    controller._first_iteration = meta.get("first_iteration", False)
    _restore_cmd(controller, arrays)


# ---------------------------------------------------------------------------
# fleets (every rank of the fleet's process group calls these)
# ---------------------------------------------------------------------------

def save_fleet(fleet, path: str) -> None:
    """Snapshot a fleet's warm state (LMPCFleet or NLMPCFleet): the ranks'
    rows are gathered, rank 0 writes the whole fleet's arrays, and every
    rank returns once the file is complete."""
    from ..parallel import mesh as mesh_lib

    if hasattr(fleet, "_warm_x"):
        tree = {"warm_x": fleet._warm_x, "warm_y": fleet._warm_y}
        kind = "lmpc_fleet"
    else:
        tree = {"opt_vector": fleet._opt_vector, "slack": fleet._slack}
        kind = "nlmpc_fleet"
    tree = {k: None if v is None else mesh_lib.all_gather_rows(fleet.mesh, v)
            for k, v in tree.items()}
    if fleet.mesh.rank == 0:
        save_pytree(path, tree, {"kind": kind, "dims": list(fleet.controller.dims)})
    mesh_lib.barrier(fleet.mesh)


def load_fleet(fleet, path: str) -> None:
    """Restore a fleet's warm state from a file of the whole fleet: each rank
    keeps its own rows."""
    arrays, meta = load_pytree(path)
    check_meta(meta, {"dims": list(fleet.controller.dims)})
    names = (("warm_x", "_warm_x"), ("warm_y", "_warm_y"))
    if meta["kind"] != "lmpc_fleet":
        names = (("opt_vector", "_opt_vector"), ("slack", "_slack"))
    for key, attr in names:
        if key in arrays:
            a = arrays[key]
            setattr(fleet, attr, _tensor(fleet.controller, a[fleet.mesh.rows(a.shape[0])]))
