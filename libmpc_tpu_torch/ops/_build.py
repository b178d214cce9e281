"""Build and load the port's CUDA kernels at first use.

The kernels (``libmpc_tpu_torch/csrc/*.cu``) have a plain C interface and
are compiled by ``nvcc`` for ``sm_90a`` — one ``nvcc -c`` per source, all
started together — linked into one shared library, then bound with
``ctypes``.  The library is cached under ``libmpc_tpu_torch/_build/``
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
SOURCES = ("admm_fused.cu", "chol_inverse.cu", "eig_clip.cu", "qp_inner.cu", "traj_factor.cu",
           "traj_sweep.cu")
HEADERS = ("chol_warp.cuh", "chol_block.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

# facts about the last build, for reports: wall seconds (0.0 when the cached
# library was loaded), the nvcc command and what nvcc printed (-Xptxas -v
# lists each kernel's registers, shared memory and spills; kept beside the
# library, so a cached load reports it too)
build_info: dict = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_SIGNATURES = {
    # x z y done q l u A At M Minv rho ox oz oy B n m k_iters sigma alpha
    # refine tier bt stages stream (At null where the layout is staged)
    "libmpc_admm_fused_f32": [_P] * 15 + [_I] * 4 + [_D, _D, _I, _I, _I, _I, _P],
    "libmpc_admm_fused_f64": [_P] * 15 + [_I] * 4 + [_D, _D, _I, _I, _I, _I, _P],
    # C out B k tier g threads stage stream
    "libmpc_chol_inverse_f32": [_P, _P] + [_I] * 6 + [_P],
    "libmpc_chol_inverse_f64": [_P, _P] + [_I] * 6 + [_P],
    # f64 B k tier g threads stage out[3]: the launch a layout gives (no launch)
    "libmpc_chol_inverse_plan": [_I] * 7 + [_P],
    # grid threads stream: a kernel that does nothing (a launch's yardstick)
    "libmpc_empty_launch": [_I, _I, _P],
    # H out sweeps B n threads stream
    "libmpc_eig_clip_f32": [_P] * 3 + [_I] * 3 + [_P],
    "libmpc_eig_clip_f64": [_P] * 3 + [_I] * 3 + [_P],
    # P A q l u rho x0 y0 dinv einv cinv | xo yo zo iters done pri dua |
    # B n m | sigma alpha eps_abs eps_rel | n_blocks check_every refine warps |
    # stream
    "libmpc_qp_inner_f32": [_P] * 18 + [_I] * 3 + [_D] * 4 + [_I] * 4 + [_P],
    "libmpc_qp_inner_f64": [_P] * 18 + [_I] * 3 + [_D] * 4 + [_I] * 4 + [_P],
    # n m elem_bytes | bytes (out): returns the tier (1 register, 0 shared)
    "libmpc_qp_inner_layout": [_I, _I, _I, _P],
    # D L C G | Sinv X Ghat | B ph bs bs_p w threads | stream
    "libmpc_traj_factor_f32": [_P] * 7 + [_I] * 6 + [_P],
    "libmpc_traj_factor_f64": [_P] * 7 + [_I] * 6 + [_P],
    # Sinv L X Ghat_inv r_stage r_g | xs g | B ph bs w warps | stream
    "libmpc_traj_sweep_f32": [_P] * 8 + [_I] * 5 + [_P],
    "libmpc_traj_sweep_f64": [_P] * 8 + [_I] * 5 + [_P],
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
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernel library if no build of the current sources exists;
    returns its path."""
    target = BUILD_DIR / f"libmpc_kernels_{_digest()}.so"
    log_file = target.with_suffix(".log")
    if target.is_file():
        build_info.update(seconds=0.0, cached=True, path=str(target),
                          log=log_file.read_text() if log_file.is_file() else "")
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    tag = f"{target.stem}.{os.getpid()}"
    objects = [BUILD_DIR / f"{tag}.{Path(s).stem}.o" for s in SOURCES]
    compiles = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(CSRC / src)]
                for src, obj in zip(SOURCES, objects)]
    tmp = BUILD_DIR / f"{tag}.tmp"
    link = [nvcc, "-shared", "-o", str(tmp), *(str(o) for o in objects)]
    t0 = time.perf_counter()
    log = []
    try:
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for cmd in compiles]
        results = [(cmd, p.communicate()[0], p.returncode)
                   for cmd, p in zip(compiles, procs)]
        done = subprocess.run(link, capture_output=True, text=True) \
            if all(rc == 0 for _, _, rc in results) else None
        if done is not None:
            results.append((link, done.stdout + done.stderr, done.returncode))
        for cmd, out, rc in results:
            log.append(out)
            if rc != 0:
                raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{out}")
        log_file.write_text("".join(log))
        os.replace(tmp, target)
    finally:
        for obj in objects:
            obj.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    build_info.update(
        seconds=seconds, cached=False, path=str(target),
        command="\n".join(" ".join(c) for c in compiles + [link]),
        log="".join(log))
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
