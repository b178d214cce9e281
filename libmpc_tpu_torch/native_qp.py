"""ctypes binding to the native dense QP oracle (``native/qp_oracle.cpp``).

The oracle is an independent OSQP-algorithm solver written in C++: one dense
QP at a time, in float64, on the host.  It is the reference the port's ADMM
solver is held against (the role MATLAB plays for the reference library),
not a path of the controllers: nothing on the card calls it, and no solve
falls back to it.

The shared library is compiled with the system ``g++`` at the first call
into ``libmpc_tpu_torch/_build/`` (listed in ``.gitignore``), keyed by a hash
of the source and the flags; a build writes a temporary file and renames it
into place, so processes that build at once never load a half-written
library.  The source under ``native/`` is only read.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np
import torch

_ROOT = Path(__file__).resolve().parent
SRC = _ROOT.parent / "native" / "qp_oracle.cpp"
BUILD_DIR = _ROOT / "_build"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class OracleSolution(NamedTuple):
    x: np.ndarray
    y: np.ndarray
    status: int
    iters: int


def build() -> Path:
    """Compile the oracle if no build of the current source and flags exists;
    returns the library's path."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    target = BUILD_DIR / f"libqp_oracle_{h.hexdigest()[:16]}.so"
    if target.is_file():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{target.stem}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp)],
                       check=True, capture_output=True)
        os.replace(tmp, target)
    finally:
        tmp.unlink(missing_ok=True)
    return target


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            dp = ctypes.POINTER(ctypes.c_double)
            lib.qp_solve_dense.restype = ctypes.c_int
            lib.qp_solve_dense.argtypes = [
                ctypes.c_int, ctypes.c_int,  # n, m
                dp, dp, dp, dp, dp,  # P, A, q, l, u
                ctypes.c_double, ctypes.c_double, ctypes.c_double,  # rho, sigma, alpha
                ctypes.c_int,  # max_iter
                ctypes.c_double, ctypes.c_double,  # eps_abs, eps_rel
                ctypes.c_int, ctypes.c_int,  # check_every, polish
                dp, dp, ctypes.POINTER(ctypes.c_int),  # x, y, iters
            ]
            _lib = lib
    return _lib


def available() -> bool:
    """Whether the oracle builds and loads here (it needs ``g++``)."""
    try:
        _load()
        return True
    except (OSError, subprocess.CalledProcessError):
        return False


def _host64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.ascontiguousarray(a, dtype=np.float64)


def solve(
    P, A, q, l, u,
    rho: float = 0.1,
    sigma: float = 1e-6,
    alpha: float = 1.6,
    max_iter: int = 4000,
    eps_abs: float = 1e-8,
    eps_rel: float = 1e-8,
    check_every: int = 25,
    polish: bool = True,
) -> OracleSolution:
    """Solve one dense QP ``min x'Px/2 + q'x, l <= Ax <= u`` with the oracle.

    The inputs may be numpy arrays or tensors on any device; they are copied
    to the host in float64.  Returns numpy arrays; ``status`` is 1 when the
    oracle solved the QP.
    """
    lib = _load()
    P, A, q, l, u = map(_host64, (P, A, q, l, u))
    n, m = P.shape[0], A.shape[0]
    if P.shape != (n, n) or A.shape != (m, n) or q.shape != (n,) \
            or l.shape != (m,) or u.shape != (m,):
        raise ValueError(f"one dense QP expected: P {P.shape}, A {A.shape}, "
                         f"q {q.shape}, l {l.shape}, u {u.shape}")
    x = np.zeros(n)
    y = np.zeros(m)
    iters = ctypes.c_int(0)
    dp = ctypes.POINTER(ctypes.c_double)
    as_p = lambda a: a.ctypes.data_as(dp)
    status = lib.qp_solve_dense(
        n, m, as_p(P), as_p(A), as_p(q), as_p(l), as_p(u),
        rho, sigma, alpha, max_iter, eps_abs, eps_rel,
        check_every, int(polish), as_p(x), as_p(y),
        ctypes.byref(iters),
    )
    return OracleSolution(x=x, y=y, status=int(status), iters=int(iters.value))
