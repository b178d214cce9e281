"""K1's share of its roofline over the profiled sub-window: the least time
the card could take for the ADMM iterations the lanes needed, over the
device time of K1's kernels.

* Device time: the profiler's kernel rows whose names hold one of
  ``PATTERNS`` (the entry kernels of ``libmpc_tpu_torch/csrc/admm_fused.cu``).
* Operations: ``4 m n + 6 n^2`` a lane-iteration (the products with A, M and
  Minv of one ADMM iteration with the float32 refinement pass, the ADMM
  model of ``libmpc_tpu_torch/utils/flops.py``, frozen here), times each
  lane's own iteration count (the controller's ``_last_iters`` of each
  profiled step), not the padded work of the lockstep.
* Bytes: a lane's iterates and data cross device memory once a block of
  ``check_termination`` iterations, ``4 (3 n + 6 m + 1)`` bytes (x, q, z, y,
  l, u and its done flag in; x, z, y out), and the shared A, M, Minv and
  rho are read once a block round of the step, ``4 (m n + 2 n^2 + m)``.
* Least time: the larger of operations over 67 TFLOP/s and bytes over
  3.35 TB/s, the H100 SXM's published float32 (outside the tensor cores)
  and memory peaks at its 700 W limit.

The count depends only on the QP's shape and the lanes' iterations, so it
reads the same work however a program splits it into launches.
"""

import math

PATTERNS = ("admm_staged_kernel", "admm_stream_kernel")
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def least_seconds(iters_by_step, n, m, check_every):
    """(least seconds, "operations" or "bytes") for per-step lists of
    per-lane iteration counts."""
    ops = 0.0
    nbytes = 0.0
    for iters in iters_by_step:
        ops += sum(iters) * (4.0 * m * n + 6.0 * n * n)
        blocks = [math.ceil(i / check_every) for i in iters]
        nbytes += 4.0 * (3 * n + 6 * m + 1) * sum(blocks)
        nbytes += 4.0 * (m * n + 2 * n * n + m) * max(blocks, default=0)
    t_ops, t_bytes = ops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def read(run, state=None):
    p = run.profile
    if p is None:
        return None
    k1 = sum(p.seconds_by(lambda name: "k1" if any(w in name for w in PATTERNS)
                          else None).values())
    if k1 <= 0:
        return None
    iters = [[int(v) for v in it.reshape(-1).tolist()] for it in run.profile_iters]
    least, by = least_seconds(iters, run.cfg["qp_n"], run.cfg["qp_m"],
                              run.cfg["solver"]["check_termination"])
    run.notes["k1_roofline_pct"] = (f"bound by {by}: least {least * 1e3:.4f} ms of "
                                    f"K1 {k1 * 1e3:.4f} ms; peaks at 700 W, card at "
                                    f"{run.power_limit}")
    return 100.0 * least / k1
