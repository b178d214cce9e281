"""Fused ADMM iteration blocks: the hand-written CUDA kernel and its twin.

Counterpart of ``libmpc_tpu/ops/admm_pallas.py``.  :func:`fused_iterations`
runs ``k_iters`` ADMM iterations for a batch that shares A, M, Minv and rho:

* on a CUDA tensor it launches ``csrc/admm_fused.cu`` (float32 or float64),
  which replaces the Pallas kernel ``admm_pallas.py::_kernel``
  (``pallas_call`` at ``admm_pallas.py:143``);
* on a CPU tensor it runs :func:`plain_iterations`, the plain PyTorch twin:
  ``one_iteration`` of ``libmpc_tpu/ops/admm.py:416-443`` looped ``k_iters``
  times.

What bounds the kernel on an H100, and what its design does about it: the
TPU kernel keeps A (m, n), M and Minv (n, n) in VMEM; at the quadrotor size
that is 836 KB in float32, beyond the 227 KB of shared memory of a Hopper
block.  The CUDA kernel keeps a tile of lanes' vectors resident in shared
memory for all ``k_iters`` iterations and streams the shared matrices from
L2, using each fetched element for every lane of the tile, in one of two
tiers chosen at launch by shape and batch (:func:`layout`):

* the stream tier (any shape): 8 float32 / 4 float64 lanes a block, three
  blocks an SM, each thread reading its matrix column through the read-only
  path, A and a transposed copy of it an iteration.  On an H100 80GB HBM3
  (700 W) it takes 6.57 ms at B=16384, n=216, m=535, 10 float32 iterations
  (the FP32 bound is 1.815 ms), reading 30.4 GB of L2 at 4.6 TB/s where a
  probe reads 7.1 TB/s;
* the staged tier (float32, n <= 256 and a multiple of 4, aligned matrices;
  float64 runs the stream tier, faster at every batch measured): one pass over
  A an iteration, the matrices in slabs through a ring of bulk (TMA) copies,
  4x4 register tiles, 4-16 lanes a block and (3 n + 2 m) words a lane
  (:func:`staged_smem_bytes`).  A block runs as fast alone as at full load;
  its products move about 100 bytes a cycle an SM from shared memory into
  registers, 2 bytes a multiply-add.  At the quadrotor shape it runs where
  a batch fits one wave of 8-lane tiles (0.74 against 0.90 ms at the
  compacted B=1,024), the stream tier elsewhere; the cost model's constants
  were fitted at that shape, and no other shape was timed.  Numbers:
  ``PERF.md``, from ``chip_smoke.py --phases k1``.
"""

from __future__ import annotations

import functools
from collections import namedtuple

import torch

from . import _build

SMEM_LIMIT_BYTES = 232448  # dynamic shared memory one Hopper block can use


def mm(X, M):
    """``X @ M`` for a matrix ``M`` shared by the batch (k, n), or one
    matrix a lane (B, k, n), where a batch of row vectors ``X`` (B, k) then
    multiplies its own lane's matrix; two batches of matrices multiply lane
    by lane."""
    if M.dim() == 3 and X.dim() == 2:
        return (X[:, None, :] @ M)[:, 0]
    return X @ M


def plain_iterations(x, z, y, done, q, l, u, A, M, Minv, rho_vec, *,
                     sigma: float, alpha: float, k_iters: int,
                     refine: bool = True, reduce=None):
    """``k_iters`` ADMM iterations in plain PyTorch (the kernel's twin).

    Shapes: x/q (B, n); z/y/l/u (B, m); done (B,) bool, or None where every
    lane runs; A (m, n), M/Minv (n, n) and rho_vec (m,) shared by the batch,
    or A (B, m, n), M/Minv (B, n, n) and rho_vec (B, m), one a lane (the
    per-instance solve, ``admm.admm_solve_each``).  ``reduce``, when
    given, is applied to each x-update's ``(rho z - y) A`` (the row-sharded
    solve sums it over the row shards: A, z, y, l, u and rho_vec are then
    the rank's row block).  Returns the updated (x, z, y).
    """
    At = A.mT
    for _ in range(k_iters):
        # x-update: (P + sigma I + A' R A) xt = sigma x - q + A'(R z - y)
        Ar = mm(rho_vec * z - y, A)
        rhs = sigma * x - q + (Ar if reduce is None else reduce(Ar))
        xt = mm(rhs, Minv)  # Minv symmetric
        if refine:
            # one refinement pass against M recovers the digits the
            # explicit float32 inverse loses
            xt = xt + mm(rhs - mm(xt, M), Minv)
        zt = mm(xt, At)
        x_new = alpha * xt + (1.0 - alpha) * x
        z_relax = alpha * zt + (1.0 - alpha) * z
        z_unc = z_relax + y / rho_vec
        z_new = torch.clamp(z_unc, min=l, max=u)
        # y is exactly zero on rows where the projection did not clip
        clipped = (z_unc < l) | (z_unc > u)
        y_new = torch.where(clipped, y + rho_vec * (z_relax - z_new), 0.0)
        if done is None:
            x, z, y = x_new, z_new, y_new
        else:
            frozen = done[:, None]
            x = torch.where(frozen, x, x_new)
            z = torch.where(frozen, z, z_new)
            y = torch.where(frozen, y, y_new)
    return x, z, y


Layout = namedtuple("Layout", "tier bt threads smem_bytes grid stages")
Layout.__doc__ = """A launch's layout: ``tier`` 1 (staged) or 0 (stream), ``bt``
lanes a block, ``threads`` a block, dynamic shared memory a block in bytes,
``grid`` blocks, ring stages (0 in the stream tier)."""

# the staged tier's tiles, largest first, and the cost model that picks a
# tile and a tier (fitted to timings of both tiers at the quadrotor shape,
# n=216, m=535; no other shape was timed: PERF.md).  The staged tier is
# float32 only: float64 ran faster on the stream tier at every batch
# measured.  SLAB_ROWS and MAX_STAGES restate kSlabRows and kMaxStages of
# csrc/admm_fused.cu.
STAGED_TILES = (16, 8, 4)
MAX_STAGES = 4  # ring stages, as many as fit up to this
TILE_COST = 4  # a tile's cost beyond its lanes, in lane units
STREAM_WAVE_COST = 20  # a wave of stream blocks, in the same units
SLAB_ROWS = 32  # matrix rows a slab of the ring
MAX_STAGED_N = 256
H100_SMS = 132
_STREAM_TILE = {torch.float32: 8, torch.float64: 4}


def _elem(dtype: torch.dtype) -> int:
    return torch.finfo(dtype).bits // 8


def _ld(k: int, elem: int) -> int:
    """Row stride of a staged lane vector or slab row of ``k`` elements: k
    rounded up to 4, padded so that a row is 16 mod 32 bytes long."""
    r = (k + 3) // 4 * 4
    return r + 16 // elem if (r * elem) % 32 == 0 else r


def staged_smem_bytes(bt: int, n: int, m: int, stages: int = 2) -> int:
    """Dynamic shared memory of a staged (float32) block: x, rhs (then the
    refinement residual) and xt (n each), z and y (m each) and one slab of w
    per lane, rows padded (``_ld``), and ``stages`` ring stages of matrix
    slabs (rows of n, as in the matrix) with a slack of 8 floats."""
    kc = SLAB_ROWS
    return 4 * (bt * (3 * _ld(n, 4) + 2 * _ld(m, 4) + _ld(kc, 4)) + stages * kc * n + 8)


def stream_smem_bytes(bt: int, n: int, m: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of a stream block: x, rhs and xt (n each), z and
    y (m each), and w, whose buffer the refinement residual reuses
    (max(n, m)), per lane."""
    return (3 * n + 2 * m + max(n, m)) * bt * _elem(dtype)


def staged_shape(n: int, m: int, dtype: torch.dtype) -> bool:
    """Shapes the staged tier takes (with 16-byte aligned matrices): float32,
    n <= 256 and rows a multiple of 16 bytes."""
    return dtype == torch.float32 and 1 <= n <= MAX_STAGED_N and m >= 1 and n % 4 == 0


def _staged_cost(B: int, bt: int, sms: int) -> int:
    return -(-(-(-B // bt)) // sms) * (bt + TILE_COST)


def staged_layout(B: int, n: int, m: int, bt: int | None = None,
                  stages: int | None = None, sms: int = H100_SMS) -> Layout | None:
    """A staged block's layout for a batch of B (the shape must pass
    :func:`staged_shape`): ``bt`` lanes a block, or, for None, the tile of
    least cost ceil(ceil(B / bt) / sms) * (bt + TILE_COST) among those that
    fit, the larger on a tie; ``stages`` ring stages, or, for None, as many
    as fit up to ``MAX_STAGES``.  None where it does not fit (fewer than two
    stages)."""
    best = None
    for t in STAGED_TILES if bt is None else (bt,):
        ns = MAX_STAGES if stages is None else stages
        while stages is None and ns > 2 and staged_smem_bytes(t, n, m, ns) > SMEM_LIMIT_BYTES:
            ns -= 1
        if (t not in STAGED_TILES or not 2 <= ns <= MAX_STAGES
                or staged_smem_bytes(t, n, m, ns) > SMEM_LIMIT_BYTES):
            continue
        if best is None or _staged_cost(B, t, sms) < _staged_cost(B, best.bt, sms):
            best = Layout(1, t, 16 * t, staged_smem_bytes(t, n, m, ns), -(-B // t), ns)
    return best


def stream_layout(B: int, n: int, m: int, dtype: torch.dtype) -> Layout | None:
    """A stream block's layout for a batch of B: 8 lanes in float32, 4 in
    float64, halved until a block fits; None where one lane does not."""
    bt = _STREAM_TILE[dtype]
    while bt >= 1:
        smem = stream_smem_bytes(bt, n, m, dtype)
        if smem <= SMEM_LIMIT_BYTES:
            return Layout(0, bt, 384, smem, -(-B // bt), 0)
        bt //= 2
    return None


@functools.lru_cache(maxsize=256)
def layout(B: int, n: int, m: int, dtype: torch.dtype, aligned: bool = True,
           sms: int = H100_SMS) -> Layout:
    """The layout :func:`fused_iterations` launches (the launcher only checks
    it).  The staged tier's :func:`staged_layout` where the shape and the
    matrices' alignment allow it, against the stream tier's
    :func:`stream_layout`, whose waves of at most 3 blocks an SM cost
    ``STREAM_WAVE_COST`` each: the staged tier where its cost is the lesser.
    At the quadrotor shape the staged tier runs where a float32 batch fits
    one wave of 8-lane tiles.  Raises ``ValueError`` when nothing fits."""
    staged = (staged_layout(B, n, m, sms=sms)
              if aligned and staged_shape(n, m, dtype) else None)
    stream = stream_layout(B, n, m, dtype)
    if stream is None and staged is None:
        raise ValueError(
            f"fused ADMM kernel: n={n}, m={m} needs {stream_smem_bytes(1, n, m, dtype)} "
            f"bytes of shared memory per lane, over the {SMEM_LIMIT_BYTES} a "
            "block can use"
        )
    if stream is None or staged is None:
        return stream or staged
    per_sm = min(3, SMEM_LIMIT_BYTES // stream.smem_bytes)
    waves = -(-stream.grid // (sms * per_sm))
    return staged if _staged_cost(B, staged.bt, sms) < waves * STREAM_WAVE_COST else stream


@functools.lru_cache(maxsize=None)
def _sms(index) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(x, z, y, done, q, l, u, A, M, Minv, rho_vec):
    if x.dtype not in _STREAM_TILE:
        raise TypeError(f"fused ADMM kernel takes float32/float64, got {x.dtype}")
    B, n = x.shape
    m = A.shape[0]
    expect = {
        "x": (x, (B, n)), "z": (z, (B, m)), "y": (y, (B, m)),
        "q": (q, (B, n)), "l": (l, (B, m)), "u": (u, (B, m)),
        "A": (A, (m, n)), "M": (M, (n, n)), "Minv": (Minv, (n, n)),
        "rho_vec": (rho_vec, (m,)),
    }
    for name, (t, shape) in expect.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
        if t.dtype != x.dtype:
            raise TypeError(f"{name}: dtype {t.dtype}, expected {x.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if done.shape != (B,) or done.dtype != torch.bool or done.device != x.device:
        raise ValueError("done must be a (B,) bool tensor on x's device")


def fused_iterations(x, z, y, done, q, l, u, A, M, Minv, rho_vec, *,
                     sigma: float, alpha: float, k_iters: int,
                     refine: bool = True):
    """Run ``k_iters`` ADMM iterations for the whole batch.

    Shapes as :func:`plain_iterations`'s shared form, ``done`` a tensor.
    CPU tensors run the plain twin; CUDA
    tensors launch the kernel (float32 or float64) at :func:`layout`'s
    choice through :func:`launch`.
    """
    if x.device.type == "cpu":
        return plain_iterations(
            x, z, y, done, q, l, u, A, M, Minv, rho_vec, sigma=sigma,
            alpha=alpha, k_iters=k_iters, refine=refine,
        )
    if x.device.type != "cuda":
        raise ValueError(f"fused ADMM kernel: unsupported device {x.device}")
    _check(x, z, y, done, q, l, u, A, M, Minv, rho_vec)
    aligned = all(t.data_ptr() % 16 == 0 for t in (A, M, Minv))
    lay = layout(x.shape[0], x.shape[1], A.shape[0], x.dtype, aligned,
                 _sms(x.device.index))
    return _launch(lay, x, z, y, done, q, l, u, A, M, Minv, rho_vec, sigma,
                   alpha, k_iters, refine)


def launch(lay: Layout, x, z, y, done, q, l, u, A, M, Minv, rho_vec, *,
           sigma: float, alpha: float, k_iters: int, refine: bool = True):
    """Launch the kernel on CUDA tensors with the layout ``lay`` in place of
    :func:`layout`'s choice (the card tests and timing sweeps force a tier,
    tile or ring depth so).  The launcher refuses, and this raises, a layout
    that does not apply to the shape or does not fit."""
    if x.device.type != "cuda":
        raise ValueError(f"fused ADMM kernel: unsupported device {x.device}")
    _check(x, z, y, done, q, l, u, A, M, Minv, rho_vec)
    return _launch(lay, x, z, y, done, q, l, u, A, M, Minv, rho_vec, sigma, alpha,
                   k_iters, refine)


def _launch(lay, x, z, y, done, q, l, u, A, M, Minv, rho_vec, sigma, alpha, k_iters,
            refine):
    """One launch on the current stream, counted in
    ``fused_iterations.launches`` (and appended to its ``trace`` if set)."""
    B, n = x.shape
    m = A.shape[0]
    if B == 0 or k_iters == 0:
        return x.clone(), z.clone(), y.clone()
    ox, oz, oy = torch.empty_like(x), torch.empty_like(z), torch.empty_like(y)
    lib = _build.library()
    fn = (lib.libmpc_admm_fused_f32 if x.dtype == torch.float32
          else lib.libmpc_admm_fused_f64)
    # only the stream tier reads a transposed copy of A
    At = A.t().contiguous() if lay.tier == 0 else None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = fn(
            x.data_ptr(), z.data_ptr(), y.data_ptr(), done.data_ptr(),
            q.data_ptr(), l.data_ptr(), u.data_ptr(), A.data_ptr(),
            None if At is None else At.data_ptr(), M.data_ptr(), Minv.data_ptr(),
            rho_vec.data_ptr(), ox.data_ptr(), oz.data_ptr(), oy.data_ptr(),
            B, n, m, int(k_iters), float(sigma), float(alpha), int(bool(refine)),
            lay.tier, lay.bt, lay.stages, stream,
        )
    if code != 0:
        _build.check(code, f"admm_fused kernel launch with {lay}")
    fused_iterations.launches += 1
    if fused_iterations.trace is not None:
        fused_iterations.trace.append((B, lay))
    return ox, oz, oy


fused_iterations.launches = 0
# diagnostic hook, None by default: a list to which every launch appends
# (B, layout)
fused_iterations.trace = None
