"""K1 of this tree against K1 of another checkout, in one process.

Run from the repository root, on a machine with one CUDA card and nvcc:

    python3 chip_k1_ab.py OTHER_CHECKOUT [--pairs 8] [--reps 24]

The other checkout's ``libmpc_tpu_torch/ops/admm_fused.py`` is loaded as a
module of another package (``chip_smoke.load_other``), so that its
``_build.py`` builds that checkout's kernel library into that checkout's
``_build`` directory; nothing else of it is imported.  Then, in turns (ABBA), windows
of the quadrotor LMPC steady state (``chip_smoke.phase_times``: warm
re-solves of one batch of 16384) run with ``ops.admm`` calling this tree's
``fused_iterations`` (``this``) or the other's (``other``), and K1 alone
is timed at B=16384 and 1024 (float32, refinement, CUDA events) in the same
turns.  One line a window, then the medians and how many pairs each won;
the last line is the card's name and power limit.  Everything but K1 is
this tree's code, so a difference between the two columns is K1's: its
wrapper and its kernel library.  Imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time
from pathlib import Path

import chip_smoke as cs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", type=Path, help="root of the other checkout")
    ap.add_argument("--pairs", type=int, default=8)
    ap.add_argument("--reps", type=int, default=24, help="warm re-solves a window")
    opts = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_k1_ab: no CUDA device", file=sys.stderr)
        return 2
    import libmpc_tpu_torch as lt
    from libmpc_tpu_torch.ops import admm, admm_fused

    admm.full_precision("cuda")  # TF32 off, as chip_smoke runs the loops
    other = cs.load_other(opts.other, "admm_fused")
    impls = {"this": admm_fused.fused_iterations, "other": other.fused_iterations}
    f32, dev, B = torch.float32, "cuda", cs.B_MAIN

    def k1_args(Bk):
        d = cs.k1_problem(Bk, cs.N_QP, cs.M_QP, seed=0 if Bk == B else 1)
        t = {k: torch.as_tensor(v, dtype=f32, device=dev) for k, v in d.items() if k != "sigma"}
        zeros = lambda w: torch.zeros((Bk, w), dtype=f32, device=dev)
        return (zeros(cs.N_QP), zeros(cs.M_QP), zeros(cs.M_QP),
                torch.zeros(Bk, dtype=torch.bool, device=dev),
                t["q"], t["l"], t["u"], t["A"], t["M"], t["Minv"], t["rho"])

    alone = {Bk: k1_args(Bk) for Bk in (B, 1024)}
    kw = dict(sigma=1e-5, alpha=1.6, k_iters=10, refine=True)
    rng = cs.np.random.default_rng(0)
    x0 = torch.as_tensor(0.05 * rng.normal(size=(B, 12)), dtype=f32, device=dev)
    c = cs.quadrotor_controller(lt, f32, dev, cs.steady_state_params(lt))
    r = c.optimize(x0, torch.zeros((B, 4), dtype=f32, device=dev))
    for fn in impls.values():  # build both libraries and load every kernel
        admm_fused.fused_iterations = fn
        r = c.optimize(x0, r.cmd)
        for a in alone.values():
            fn(*a, **kw)
    admm_fused.fused_iterations = impls["this"]
    torch.cuda.synchronize()

    rows = {k: [] for k in impls}
    order = [k for p in range(opts.pairs)
             for k in (("this", "other") if p % 2 == 0 else ("other", "this"))]
    for i, key in enumerate(order):
        fn = impls[key]
        admm_fused.fused_iterations = fn
        try:
            r = c.optimize(x0, r.cmd)
            torch.cuda.synchronize()
            n0 = fn.launches
            t0 = time.perf_counter()
            for _ in range(opts.reps):
                r = c.optimize(x0, r.cmd)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = fn.launches - n0
            iters = c._last_iters.float().mean().item()
        finally:
            admm_fused.fused_iterations = impls["this"]
        ms = {Bk: cs.cuda_ms(torch, lambda: fn(*a, **kw), reps=10) for Bk, a in alone.items()}
        row = dict(solves_per_s=B * opts.reps / wall, step_ms=1e3 * wall / opts.reps,
                   iters_mean=iters, k1_launches=launches, k1_ms_B16384=ms[B],
                   k1_ms_B1024=ms[1024])
        rows[key].append(row)
        print(f"[k1-ab] window={i} impl={key} "
              + " ".join(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                         for k, v in row.items()), flush=True)
    for field in ("solves_per_s", "step_ms", "iters_mean", "k1_ms_B16384", "k1_ms_B1024"):
        med = {k: statistics.median(x[field] for x in v) for k, v in rows.items()}
        spread = {k: (min(x[field] for x in v), max(x[field] for x in v))
                  for k, v in rows.items()}
        print(f"[k1-ab-median] {field} this={med['this']:.4f} other={med['other']:.4f} "
              f"this_range={spread['this'][0]:.4f}..{spread['this'][1]:.4f} "
              f"other_range={spread['other'][0]:.4f}..{spread['other'][1]:.4f}", flush=True)
    wins = sum(a["solves_per_s"] > b["solves_per_s"] for a, b in zip(rows["this"], rows["other"]))
    print(f"[k1-ab-pairs] steady_state_this_won={wins} of={opts.pairs}", flush=True)
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
