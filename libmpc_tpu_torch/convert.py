"""Carry the JAX package's data into the port and back, as numpy arrays.

The two packages compute the same things from the same data: a test builds
a controller in ``libmpc_tpu``, converts its problem record (``_prob``), its
prepared solver state (``_built``) or its warm start to numpy
(``{k: np.asarray(v)}``), and hands them to these functions to get the
port's tensors on a chosen device and dtype.  Nothing here imports JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Tuple

import numpy as np
import torch

from .lmpc.problem import LProblemData
from .ops.admm import PreparedQP


def _tensor(v, device, dtype):
    a = np.array(v)  # a writable copy (arrays read from JAX are read-only)
    if a.dtype == np.bool_:
        return torch.as_tensor(a, device=device)
    return torch.as_tensor(a, dtype=dtype, device=device)


def problem_from_numpy(arrays: Mapping[str, np.ndarray], device="cpu",
                       dtype=torch.float64) -> LProblemData:
    """An :class:`LProblemData` from numpy arrays named by its fields."""
    names = [f.name for f in dataclasses.fields(LProblemData)]
    missing = set(names) - set(arrays)
    if missing:
        raise KeyError(f"problem arrays missing {sorted(missing)}")
    return LProblemData(**{k: _tensor(arrays[k], device, dtype) for k in names})


def problem_to_numpy(prob: LProblemData) -> dict:
    return {f.name: getattr(prob, f.name).detach().cpu().numpy()
            for f in dataclasses.fields(LProblemData)}


def prepared_from_numpy(arrays: Mapping[str, Optional[np.ndarray]],
                        device="cpu", dtype=torch.float64) -> PreparedQP:
    """A :class:`PreparedQP` from numpy arrays named by its fields (the
    masks keep their bool dtype; ``Mpinv``/``Mpinv_lo`` may be None)."""
    return PreparedQP(**{
        k: None if arrays[k] is None else _tensor(arrays[k], device, dtype)
        for k in PreparedQP._fields
    })


def prepared_to_numpy(prep: PreparedQP) -> dict:
    return {k: None if v is None else v.detach().cpu().numpy()
            for k, v in prep._asdict().items()}


def warm_start_from_numpy(x, y, device="cpu",
                          dtype=torch.float64) -> Tuple[torch.Tensor, torch.Tensor]:
    return _tensor(x, device, dtype), _tensor(y, device, dtype)


def warm_start_to_numpy(x, y) -> Tuple[np.ndarray, np.ndarray]:
    return x.detach().cpu().numpy(), y.detach().cpu().numpy()
