"""K3's share of its roofline over the profiled sub-window: the least time
the card could take for the fused inner-QP solves of the sub-window, over
the device time of K3's kernels.

* Device time: the profiler's kernel rows whose names hold ``qp_inner`` (the
  entry kernels of ``libmpc_tpu_torch/csrc/qp_inner.cu``).
* Operations: for each instance-solve, its own iterations times
  ``4 m n + 6 n^2`` (the products with A, A', M^-1 and the refinement's M of
  one ADMM iteration), plus one KKT assembly and inverse,
  ``2 n^2 m + m n + n^3``.  The iterations are the fused engine's counter
  ``ops/qp_inner_fused.py::solve_batched.trace`` over the sub-window, which
  ``k3_iters_mean``'s ``close`` arms for it; refactorizations of the
  adaptive rho are not counted.
* Bytes: each instance's P, A, q, l, u, rho and warm starts x, y read once,
  and its x, y and z written once, ``n^2 + m n + 3 n + 6 m`` words.
* Least time: the larger of operations over 67 TFLOP/s and bytes over
  3.35 TB/s, the H100 SXM's published float32 (outside the tensor cores)
  and memory peaks at its 700 W limit.

Both counts depend only on the QP's shape and each instance's iterations,
so they read the same work however a program implements it.
"""

from mpcbench.metrics import k3_iters_mean

PATTERN = "qp_inner"
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def least_seconds(iters, n, m, word_bytes=4):
    """(least seconds, "operations" or "bytes") for a list of per-instance
    iteration counts, one entry an instance-solve."""
    solves = len(iters)
    ops = sum(iters) * (4.0 * m * n + 6.0 * n * n) + solves * (
        2.0 * n * n * m + m * n + float(n) ** 3)
    nbytes = solves * word_bytes * (n * n + m * n + 3.0 * n + 6.0 * m)
    t_ops, t_bytes = ops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def open(run):
    return k3_iters_mean.open(run)


def close(run, state=None):
    return k3_iters_mean.close(run, state)


def read(run, state=None):
    iters = k3_iters_mean.profile_iters(run)
    p = run.profile
    if p is None or iters is None or iters.numel() == 0:
        return None
    k3 = sum(p.seconds_by(lambda name: "k3" if PATTERN in name else None).values())
    if k3 <= 0:
        return None
    word = 8 if run.cfg["dtype"] == "float64" else 4
    least, by = least_seconds([int(v) for v in iters.tolist()], run.cfg["qp_n"],
                              run.cfg["qp_m"], word)
    run.notes["k3_roofline_pct"] = (f"bound by {by}: least {least * 1e3:.4f} ms of "
                                    f"K3 {k3 * 1e3:.4f} ms over {iters.numel()} "
                                    f"instance-solves; peaks at 700 W, card at "
                                    f"{run.power_limit}")
    return 100.0 * least / k3
