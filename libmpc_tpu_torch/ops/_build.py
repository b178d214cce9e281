"""Build and load the port's CUDA kernels at first use.

The kernels (``libmpc_tpu_torch/csrc/*.cu``) have a plain C interface and
are compiled by ``nvcc`` into one shared library for ``sm_90a``, then bound
with ``ctypes``.  The library is cached under ``libmpc_tpu_torch/_build/``
(listed in ``.gitignore``), keyed by a hash of the sources and the compiler
flags, so a checkout builds once and a changed source rebuilds.

Nothing here runs at import time: :func:`library` compiles (if needed) and
loads on its first call, which the kernel wrappers make only for CUDA
tensors.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("admm_fused.cu", "chol_inverse.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

# facts about the last build, for reports: wall seconds (0.0 when the cached
# library was loaded), the nvcc command and what nvcc printed (-Xptxas -v
# lists each kernel's registers, shared memory and spills)
build_info: dict = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_SIGNATURES = {
    # x z y done q l u A At M Minv rho ox oz oy B n m k_iters sigma alpha
    # refine bt stream
    "libmpc_admm_fused_f32": [_P] * 15 + [_I] * 4 + [_D, _D, _I, _I, _P],
    "libmpc_admm_fused_f64": [_P] * 15 + [_I] * 4 + [_D, _D, _I, _I, _P],
    # C out B k stream
    "libmpc_chol_inverse_f32": [_P, _P, _I, _I, _P],
    "libmpc_chol_inverse_f64": [_P, _P, _I, _I, _P],
}


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``/usr/local/cuda/bin``,
    then ``PATH``."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels of "
            "libmpc_tpu_torch are built from csrc/ at first use"
        )
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernel library if no build of the current sources exists;
    returns its path."""
    target = BUILD_DIR / f"libmpc_kernels_{_digest()}.so"
    if target.is_file():
        build_info.update(seconds=0.0, cached=True, path=str(target))
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(CSRC / s) for s in SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, target)
    build_info.update(seconds=seconds, cached=False, path=str(target),
                      command=" ".join(cmd), log=proc.stdout + proc.stderr)
    return target


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on the first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.libmpc_cuda_error_string.argtypes = [_I]
            lib.libmpc_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if code != 0:
        msg = library().libmpc_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
