#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

Drives the port's main paths after building the six hand-written CUDA
kernels from ``libmpc_tpu_torch/csrc`` and holding each against its plain
PyTorch twin on the card:

* the batched quadrotor LMPC control step of the reference's
  examples/quadrotor_ex.cpp through ``libmpc_tpu_torch.LMPC`` at the bench
  size (B=16384 lanes, 16 closed-loop steps);
* the batched Van der Pol NLMPC closed loop of examples/vanderpol_ex.cpp
  through ``libmpc_tpu_torch.NLMPC`` and ``nlmpc_rollout`` (B=4096 lanes, 16
  steps, float32, ``inner_qp="fused"``, ``hessian_reg="gershgorin"``);
* the networked-oscillators NLMPC closed loop of
  examples/networked_oscillators_ex.cpp (nx=12, nu=6, ph=20, ch=10, nz=301)
  through ``nlmpc_rollout`` (B=1024 lanes, 8 steps, float32, the shipped
  two-phase settings): its ``inner_qp="fused"`` request is past the fused
  kernel's gate and runs the banded-KKT interior point;
* the UGV obstacle-avoidance NLMPC closed loop of examples/ugv_ex.cpp (nx=4,
  nu=2, ph=ch=10, two obstacles, nz=61) through ``nlmpc_rollout`` (B=256
  lanes, 150 steps as five chained 30-step rollouts, float32, the shipped
  ``inner_qp="admm"``, ``hessian_reg="eigh"`` settings): the per-instance
  inner ADMM, whose KKT inverses, polish capacitances and second-order
  corrections go through K2, and the eigenvalue clipping through K6;
* the batch-sharded fleets of ``libmpc_tpu_torch.parallel`` over
  ``torch.distributed``: ``LMPCFleet`` on the quadrotor loop (K1, K2) and
  ``NLMPCFleet`` on the Van der Pol loop (K3, K2), as one NCCL rank and as
  two gloo ranks sharing the card;
* the row-sharded QP, ``parallel.solve_sharded`` on the quadrotor QP
  (n=216, m=535) over a ``(data, model)`` mesh: one NCCL rank, then two and
  four gloo ranks sharing the card.  It runs no kernel, as the JAX
  package's row-sharded solve runs no Pallas kernel;
* the user surface: the pympcxx layer ``libmpc_tpu_torch.compat``, the six
  examples of ``examples/torch`` as shipped and the port's float64 ADMM
  against the native C++ QP oracle (``libmpc_tpu_torch.native_qp``).

Phases, one line each (any failure raises and the script exits non-zero):

1. environment: card, power limit, CUDA, nvcc, triton; TF32 off
2. build of the kernel library by nvcc for sm_90a
3. K1 (fused ADMM iterations) against its twin, float32 and float64, at
   B=16384, the compacted 1024, a ragged 1003 and B=1, and at every staged
   tile forced; a ``K1-speed`` line
4. K2 (batched Cholesky inverse) against its twin, float32 and float64, at
   the LMPC polish's shape, at the Van der Pol path's shapes and at the
   oscillators' border shape (1024,8,8); its blocked recursion at
   (256,302,302) and (256,240,240); every k from 1 to 64 at the layout's
   choice and, for k <= 32, with the block tier forced (``K2-every-k``);
   ``K2-speed`` lines, the UGV path's shapes among them
5. K3 (whole inner-QP solve) against its twin, float64 and float32, ragged
   batch included; a ``K3-speed`` line
6. K4 (banded factorization) and K5 (banded solve) against their twins,
   float64 and float32, at the oscillators' shape, on a ragged batch and on
   a single-stage problem; float32 K4 and its twin both against float64 on
   ill-conditioned blocks (the six-term construction of the reference's
   test; real interior-point iterations of the oscillator path); K5 also on
   inputs whose base pointers are not 16-byte aligned; K4, K2 and K5
   together against a dense solve; a ``K4-speed`` and a ``K5-speed`` line;
   K6 (the SQP's eigenvalue clipping) against the float64 twin at the UGV's
   (256,61,61), float32 and float64, and a ``K6-speed`` line each
7. LMPC main path, float32: the closed loop through K1 and K2, launch
   counts (K1's by batch size and tile: ``K1-launches``), status mix,
   success fraction; the unbatched float32 golden
8. LMPC matched-state accuracy against the float64 closed-loop oracle
9. LMPC float64 20-step golden trajectory on the card
10. NLMPC main path, float32: the closed loop through K3 and K2, launch
    counts, SQP and K3 iteration statistics, success fraction
11. NLMPC matched-state accuracy against the float64 Van der Pol oracle
12. NLMPC float64 20-step golden trajectory on the card (the banded engine
    in float64: K4, K5, K2)
13. oscillator main path, float32: the closed loop through K4, K5 and K2,
    launch counts, SQP and interior-point iteration statistics, rescued
    lanes, success fraction at B=1024 and at B=256 and 512
14. oscillator accuracy at matched states: float64 riccati against float64
    pdip on the card, then float32 against that
15. UGV main path, float32: the closed loop through K2 and K6, K2's
    launches by shape, K6's launches, SQP and inner-ADMM iteration statistics, avoid/goal/success
    fractions (gated: avoid 1.0, success >= 0.99) beside the float64
    oracle's and the JAX package's TPU record, host reads and K2 launches a
    step; the per-instance engine in float64 on the first SQP iteration's
    QPs, K2 against its twin substituted (statuses and iterations equal, x
    within 1e-9); K2 against its twin at (256,61,61), (256,40,40),
    (256,24,24) in both types (timed on their ``K2-speed`` lines)
16. fleet: one NCCL rank on the card runs the quadrotor ``LMPCFleet``
    (B=16384 x 16 steps) and the Van der Pol ``NLMPCFleet`` (B=4096 x 4
    steps), float32, each beside the plain controller on the same inputs
    (commands equal to the bit at every step, stats against the controller's
    statuses, success >= 0.999, K1/K2/K3 launches counted), then
    ``save_fleet``/``load_fleet`` into a fresh fleet (the next step equal to
    the bit); then the script re-runs itself as two gloo ranks sharing the
    card (``--fleet-rank``): quadrotor B=16384 x 4 steps and Van der Pol
    B=1024 x 2 steps, each rank's rows equal to the plain controller on those
    rows, the gathered result the shards' concatenation, the stats the sums
    of the halves on both ranks; a ``fleet`` line with solves/s and the
    collectives' ms a step
17. qp_sharded: the quadrotor QP through ``solve_sharded`` with the
    closed-loop settings (the dense polish under rows).  (a) one NCCL rank,
    mesh (1, 1): float32 at B=16384 (success >= 0.999, the x0 = 0 lane within
    1e-4 of the golden, commands within p99 1e-4 of the unsharded float64
    solve) beside the unsharded float32 solve (K1's path); float64 at B=1024
    against the unsharded solve on the plain path with the dense polish
    (statuses and iterations equal, x within 1e-12).  (b) two gloo ranks on
    (1, 2) and (c) four on (2, 2) sharing the card (``--qp-rank``), B=1024:
    float64 statuses and iterations equal to (a)'s, x and y within 1e-9;
    float32 golden within 1e-4, success >= 0.999; every rank the same global
    solution to the bit.  Wall ms a solve, the collectives' count and host
    ms, mean and max iterations and K1 launches (0) of each part
18. surface: the quadrotor golden through ``compat`` in float32 and float64
    (within 1e-4, SUCCESS, the optimal state sequence (11, 12)); the
    reference's example_nl loop through ``compat`` to convergence (one
    solution counted a step, commands <= 0.5 + 1e-5); each ``main()`` of
    ``examples/torch`` (quadrotor: the B=1024 batch feasible; Van der Pol:
    converged; oscillators: commands <= 0.5 + 1e-5, x'x within 1 % of the
    float64 run's, ``OSC_EX_ENERGY_F64``; UGV: goal
    within 0.05, each obstacle cleared by r - 0.05; fleet: every lane
    SUCCESS; serving: instance 3 ERROR holding its command, the resumed fleet
    SUCCESS); float64 ``admm_solve`` on the quadrotor QP within 1e-5 of the
    oracle, whose command is within 1e-4 of the golden.  Wall seconds, steps,
    statuses and kernel launches of each part (a ``surface`` JSON line); the
    path must launch all five kernels

Each kernel's speed line (``K1-speed`` ... ``K6-speed``) is the one place
that times it: the kernel, its plain twin, the library call for the same
function where there is one, and the bound.  The closed loops that a cell
of ``BENCHMARK.json`` measures (the quadrotor, Van der Pol and UGV loops)
are timed by ``python3 -m mpcbench.run`` alone; the lines here time only
the loops no cell covers (the oscillators, the fleets, the row-sharded QP,
the user surface).

``--phases a,b,...`` runs a subset (names: k1 k2 k3 k4 k5 k6 lmpc nlmpc
osc ugv fleet qp_sharded surface; ``--phases k1`` is K1's one-minute
check: its twin comparisons and a ``K1-speed`` line with its time at the
main path's batches in both types, the twin's time,
each tier forced, the bound, the layout, the L2 bytes a launch and their
rate, registers and spills (``--sweep-k1`` adds a ``K1-sweep`` line: the
probe's L2 read rate, tiers at more batches, tiles and ring depths);
``--phases k3`` is K3's one-minute check: its twin comparisons and a
``K3-speed`` line with its float32 and float64 time, bound, registers,
spills, tier, iteration histogram and one instance's time per iteration;
``--phases k4`` is K4's, with a ``K4-speed`` line; ``--phases k5`` is
K5's, with a ``K5-speed`` line; ``--phases k2`` is K2's, with a
``K2-speed`` line for each of ``K2_SPEED_SHAPES`` in both types: device time
from CUDA graphs of launches and an empty kernel's on K2's grid (medians of
seven interleaved repetitions, and the range of their difference), host us
a call, the bound, the twin's and ``torch.linalg.inv``'s time, the time
before the redesign, the layout, registers and spills (``--sweep-k2`` adds
a ``K2-sweep`` line: every other layout the library has, forced);
``--k2-ablate`` times K2's register tier without its passes or its stores),
``--profile`` with ``osc`` adds a ``torch.profiler`` breakdown of the
oscillator loop and the oscillator rollout's idle share from one traced
window (no cell traces that loop; ``python3 -m mpcbench.run --trace 1``
breaks down the cells' loops), ``--k1-clocks`` counts the cycles of each phase of a staged K1
block, ``--sweep-k3`` times K3 for several warps per block, ``--k3-clocks`` counts
the cycles of each phase of K3's register tier and ``--k4-clocks`` those of
each barrier phase of K4; with no arguments every
phase runs.  The second-to-last line is one JSON object
describing each kernel; the last line is ``{"ok": true, "device": {...}}``
(both only when every phase ran).

Run from the repository root:  python3 chip_smoke.py
It needs one CUDA card and the CUDA toolkit (nvcc); it imports neither JAX
nor the JAX package.  The quadrotor setup restates
``__graft_entry__.py:26-78`` and the closed-loop inputs and settings restate
``bench.py:268-300``; the Van der Pol setup, inputs and plant restate
``bench.py:437-480``, the oscillators' ``bench.py:562-620`` and the UGV's
``bench.py:672-822`` (these files import JAX, so they are not imported).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
GOLDEN_CMD = np.array([-0.9916, 1.74839, -0.9916, 1.74839])
B_MAIN, K_MAIN = 16384, 16
N_QP, M_QP = 216, 535  # quadrotor QP: nz, constraint rows (dims.py:43-79)
B_NL, K_NL = 4096, 16  # Van der Pol closed loop (bench.py:459)
N_NL, ME_NL, MI_NL = 26, 20, 11  # its inner QP: n = nz, m = me + mi + nz = 57
M_NL = ME_NL + MI_NL + N_NL
# networked oscillators (examples/networked_oscillators_ex.cpp; bench.py:562-627)
B_OSC, K_OSC = 1024, 8
PH_O, CH_O, NX_O, NU_O = 20, 10, 12, 6
BSP_O, BS_O, W_O = NX_O + NU_O, 2 * NX_O + NU_O, NU_O + 2  # stage block 30 (18 primal), border 8
NZ_O, ME_O, MI_O = PH_O * NX_O + CH_O * NU_O + 1, PH_O * NX_O, (PH_O + 1) * NU_O
OSC_JAX_SUCCESS = {256: 0.999, 512: 0.9966, 1024: 0.9973}  # the JAX package's float32 records
# settings of the fused inner-QP solver on the SQP's path (ops/sqp.py)
K3_KW = dict(sigma=1e-5, alpha=1.6, eps_abs=5e-6, eps_rel=5e-6, max_iter=300,
             check_every=25)
K3_MS_BEFORE = 2.566  # K3 float32 at Van der Pol's shape before its redesign (PERF.md)
# published peaks of one H100 SXM (NVIDIA's data sheet, dense, 700 W): float32
# outside the tensor cores (the tensor cores' TF32 rounds its inputs, so it is
# not the same function), float64 on the tensor cores (their FP64 products
# round as an fma does, so 67 TFLOP/s is the least time for float64 work;
# 34 outside them), and the device memory rate
PEAK_FLOPS_F32 = 67e12
PEAK_FLOPS_F64 = 67e12
PEAK_BYTES = 3.35e12
SECTOR_BYTES = 32  # the unit the memory moves


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


T_START = time.perf_counter()


def phase(name: str, **fields) -> None:
    """One line per phase: its fields, and the seconds since the script began."""
    body = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"[{name}] {body} t={time.perf_counter() - T_START:.0f}s", flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# -- the quadrotor of examples/quadrotor_ex.cpp:19-45 -------------------------
def quadrotor_model():
    Ad = np.array([
        [1, 0, 0, 0, 0, 0, 0.1, 0, 0, 0, 0, 0],
        [0, 1, 0, 0, 0, 0, 0, 0.1, 0, 0, 0, 0],
        [0, 0, 1, 0, 0, 0, 0, 0, 0.1, 0, 0, 0],
        [0.0488, 0, 0, 1, 0, 0, 0.0016, 0, 0, 0.0992, 0, 0],
        [0, -0.0488, 0, 0, 1, 0, 0, -0.0016, 0, 0, 0.0992, 0],
        [0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0.0992],
        [0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0],
        [0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0],
        [0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0],
        [0.9734, 0, 0, 0, 0, 0, 0.0488, 0, 0, 0.9846, 0, 0],
        [0, -0.9734, 0, 0, 0, 0, 0, -0.0488, 0, 0, 0.9846, 0],
        [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0.9846],
    ])
    Bd = np.array([
        [0, -0.0726, 0, 0.0726],
        [-0.0726, 0, 0.0726, 0],
        [-0.0152, 0.0152, -0.0152, 0.0152],
        [0, -0.0006, -0.0000, 0.0006],
        [0.0006, 0, -0.0006, 0],
        [0.0106, 0.0106, 0.0106, 0.0106],
        [0, -1.4512, 0, 1.4512],
        [-1.4512, 0, 1.4512, 0],
        [-0.3049, 0.3049, -0.3049, 0.3049],
        [0, -0.0236, 0, 0.0236],
        [0.0236, 0, -0.0236, 0],
        [0.2107, 0.2107, 0.2107, 0.2107],
    ])
    return Ad, Bd


def quadrotor_controller(lt, dtype, device, params):
    """The quadrotor LMPC of __graft_entry__.py:56-78 (test_common.cpp:93-224)."""
    inf = lt.inf
    Ad, Bd = quadrotor_model()
    c = lt.LMPC(12, 4, 4, 12, 10, 10, dtype=dtype, device=device)
    c.set_state_space_model(Ad, Bd, np.eye(12))
    c.set_disturbances(np.zeros((12, 4)), np.zeros((12, 4)))
    c.set_objective_weights(
        np.array([0, 0, 10, 10, 10, 10, 0, 0, 0, 5, 5, 5], float),
        np.full(4, 0.1), np.zeros(4), lt.HorizonSlice(0, 10),
    )
    xmin = np.array([-np.pi / 6, -np.pi / 6, -inf, -inf, -inf, -1,
                     -inf, -inf, -inf, -inf, -inf, -inf])
    xmax = np.array([np.pi / 6, np.pi / 6] + [inf] * 10)
    c.set_state_bounds(xmin, xmax, lt.HorizonSlice(0, 10))
    u0 = 10.5916
    c.set_input_bounds(np.full(4, 9.6 - u0), np.full(4, 13.0 - u0),
                       lt.HorizonSlice(0, 10))
    y_ref = np.zeros(12)
    y_ref[2] = 1.0
    c.set_references(y_ref, np.zeros(4), np.zeros(4), lt.HorizonSlice(0, 10))
    c.set_optimizer_parameters(params)
    return c


def quadrotor_qp(torch, lt, dtype, device, x0, u0):
    """The quadrotor controller's QP at states ``x0`` (B, 12) and last
    commands ``u0`` (B, 4), built by the port's ``lmpc/problem.py`` as
    tests/test_qp_sharded.py::test_quadrotor_qp_sharded builds the JAX
    package's: (P, A, q, l, u, eq_mask, cmd) with ``cmd(x)`` the first
    command of each lane of a solution x (B, n)."""
    from libmpc_tpu_torch.lmpc import problem as qp

    c = quadrotor_controller(lt, dtype, device, lt.LParameters())
    dims, prob = c.dims, c._prob
    P, A, lineq, uineq = qp.build_time_invariant(dims, prob)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    q, l, u = qp.build_time_varying(dims, prob, lineq, uineq, t(x0), t(u0),
                                    c._y_ref, c._u_ref, c._du_ref, c._u_meas)
    eq_mask = torch.arange(dims.m, device=device) < dims.n_eq
    cmd = lambda x: qp.unpack_solution(dims, prob, x, c._u_meas)[1][:, 0]
    return P, A, q, l, u, eq_mask, cmd


def closed_loop_params(lt):
    """Production closed-loop settings (bench.py:279-300)."""
    return lt.LParameters(
        maximum_iteration=250, enable_warm_start=True, warm_start_shift=True,
        polish=True, polish_mode="shared", rho=0.01, cold_rho=0.1,
        check_termination=10,
    )


def closed_loop_inputs(B, K, nx=12):
    """Initial states and per-step process noise (bench.py:268-276)."""
    rng = np.random.default_rng(7)
    x0 = 0.05 * rng.normal(size=(B, nx))
    noise = 0.002 * rng.normal(size=(K, B, nx))
    return x0, noise


# -- kernel data --------------------------------------------------------------
def k1_problem(B, n, m, seed=0):
    """Random shared-structure QP data as tests/test_admm_pallas.py:46-63
    builds it (float64 here; cast per dtype by the caller)."""
    rng = np.random.default_rng(seed)
    L = rng.normal(size=(n, n))
    P = L @ L.T + 0.5 * np.eye(n)
    A = rng.normal(size=(m, n))
    rho = np.full(m, 0.1)
    sigma = 1e-5
    M = P + sigma * np.eye(n) + (A.T * rho) @ A
    Minv = np.linalg.inv(M)
    q = rng.normal(size=(B, n))
    zc = rng.normal(size=(B, n)) @ A.T
    w = rng.uniform(0.3, 1.0, size=(B, m))
    l, u = zc - w, zc + w
    l[:, 0] = -np.inf
    u[:, 1] = np.inf
    return dict(q=q, l=l, u=u, A=A, M=M, Minv=Minv, rho=rho, sigma=sigma)


def k1_case(torch, admm_fused, data, dtype, refine, frozen_lane=3, lay=None):
    """Kernel (at the layout ``lay``, or at its own choice for None) and twin
    from the same nonzero state with one frozen lane (``frozen_lane``; None:
    none).  Returns (worst error relative to the twin's inf-norm, max abs
    error, frozen lane bitwise untouched)."""
    dev = "cuda"
    t = {k: torch.as_tensor(v, dtype=dtype, device=dev)
         for k, v in data.items() if k != "sigma"}
    B, n = t["q"].shape
    m = t["A"].shape[0]
    kw = dict(sigma=data["sigma"], alpha=1.6, refine=refine)
    zeros = lambda w: torch.zeros((B, w), dtype=dtype, device=dev)
    args = (t["q"], t["l"], t["u"], t["A"], t["M"], t["Minv"], t["rho"])
    # a nonzero start: two twin iterations from the origin
    x, z, y = admm_fused.plain_iterations(
        zeros(n), zeros(m), zeros(m), torch.zeros(B, dtype=torch.bool, device=dev),
        *args, k_iters=2, **kw)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    if frozen_lane is not None:
        done[frozen_lane] = True
    out_k = (admm_fused.fused_iterations(x, z, y, done, *args, k_iters=10, **kw)
             if lay is None else admm_fused.launch(lay, x, z, y, done, *args, k_iters=10,
                                                   **kw))
    out_t = admm_fused.plain_iterations(x, z, y, done, *args, k_iters=10, **kw)
    torch.cuda.synchronize()
    rel, absmax = 0.0, 0.0
    for k_, t_ in zip(out_k, out_t):
        diff = (k_ - t_).abs().max().item()
        require(torch.isfinite(k_).all().item(), "K1 output finite")
        rel = max(rel, diff / max(t_.abs().max().item(), 1e-30))
        absmax = max(absmax, diff)
    frozen_ok = frozen_lane is None or all(
        torch.equal(o[frozen_lane], s[frozen_lane]) for o, s in zip(out_k, (x, z, y)))
    return rel, absmax, frozen_ok


def spd_batch(B, k, seed=0):
    rng = np.random.default_rng(seed)
    Q = rng.normal(size=(B, k, k))
    return Q @ np.transpose(Q, (0, 2, 1)) / k + 0.5 * np.eye(k)


def cuda_ms(torch, fn, reps=10, warmup=2):
    """Mean device milliseconds per call of ``fn`` (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(torch, fn, n=20, reps=5):
    """Mean device milliseconds per call of ``fn``: CUDA events around
    ``reps`` replays of a CUDA graph that holds ``n`` calls, so that the
    host's time per call is not in it (captured after two warm calls, in
    relaxed mode)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (reps * n)
    del graph
    return ms


def host_us(torch, fn, n=200):
    """Host microseconds per call of ``fn``: the host clock around ``n``
    calls that do not wait for the device (the device's queue is deep
    enough for them)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t1 - t0) / n


# -- phases -------------------------------------------------------------------
def phase_environment(torch, admm):
    card = nvidia_smi_line()
    print(card, flush=True)
    nvcc = subprocess.run([_build_mod().find_nvcc(), "--version"],
                          capture_output=True, text=True, check=True)
    try:
        import triton  # noqa: F401  (recorded only: the port does not use it)
        triton_state = f"imports ({triton.__version__})"
    except ImportError as exc:
        triton_state = f"does not import ({exc})"
    admm.full_precision("cuda")
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())
    require(tf32 == (False, False, "highest"), f"TF32 off, got {tf32}")
    phase("environment", card=repr(card), device=repr(torch.cuda.get_device_name(0)),
          count=torch.cuda.device_count(), torch=torch.__version__,
          cuda=torch.version.cuda, python=sys.version.split()[0],
          nvcc=repr(nvcc.stdout.strip().splitlines()[-1]),
          triton=repr(triton_state), tf32_matmul=tf32[0], tf32_cudnn=tf32[1],
          matmul_precision=tf32[2])
    return card


def _build_mod():
    from libmpc_tpu_torch.ops import _build
    return _build


def phase_build():
    """Build (or, in a checkout that already built these sources, load) the
    kernel library; the library's name carries the hash of the sources."""
    b = _build_mod()
    b.library()
    info = b.build_info
    phase("build", seconds=f"{info['seconds']:.1f}", target="sm_90a",
          cached=info["cached"], library=Path(info["path"]).name)
    if not info["cached"]:
        print("  nvcc: " + info["command"], flush=True)
        for ln in info["log"].splitlines():
            if "entry function" in ln or "registers" in ln or "spill" in ln:
                print("  ptxas: " + ln.strip(), flush=True)


def k1_layout(admm_fused, B, dtype, n=N_QP, m=M_QP):
    """The kernel's layout for a launch as a string."""
    lay = admm_fused.layout(B, n, m, dtype)
    tier = "staged" if lay.tier == 1 else "stream"
    slab = f",slab={admm_fused.SLAB_ROWS}" if lay.tier == 1 else ""
    stages = f",stages={lay.stages}" if lay.tier == 1 else ""
    return (f"{tier}(bt={lay.bt},cluster=1{slab}{stages},threads={lay.threads},"
            f"smem={lay.smem_bytes})")


def phase_k1(torch, admm_fused):
    """K1 against its twin: the quadrotor shape at B=16384, the compacted
    straggler batch (1024), a ragged batch (1003) and one lane, float32 with
    refinement within 1e-4 of the twin's scale and float64 within 1e-10; a
    frozen lane bitwise untouched in every case (B=1 runs once frozen and
    once not)."""
    res = {}
    cases = [(B, dtype, refine, tol, frozen)
             for B, frozen in ((B_MAIN, 3), (1024, 3), (1003, 3), (1, None), (1, 0))
             for dtype, refine, tol in ((torch.float32, True, 1e-4),
                                        (torch.float64, False, 1e-10))]
    for B, dtype, refine, tol, frozen_lane in cases:
        data = k1_problem(B, N_QP, M_QP, seed=0 if B == B_MAIN else 1)
        rel, absmax, frozen = k1_case(torch, admm_fused, data, dtype, refine, frozen_lane)
        name = str(dtype).split(".")[-1]
        phase("K1", dtype=name, B=B, n=N_QP, m=M_QP, k_iters=10, refine=refine,
              layout=k1_layout(admm_fused, B, dtype), rel_err=f"{rel:.3e}",
              max_abs_err=f"{absmax:.3e}", tol=tol, frozen_lane=frozen_lane,
              frozen_lane_bitwise=frozen)
        require(rel <= tol, f"K1 {name} B={B} within {tol} of its twin")
        require(frozen, f"K1 {name} B={B} frozen lane untouched")
        if B == B_MAIN:
            res[name] = absmax
    # every staged (float32) tile that fits, forced, on the ragged batch
    data = k1_problem(1003, N_QP, M_QP, seed=1)
    for bt in admm_fused.STAGED_TILES:
        lay = admm_fused.staged_layout(1003, N_QP, M_QP, bt)
        if lay is None:
            continue
        rel, _, frozen = k1_case(torch, admm_fused, data, torch.float32, True, lay=lay)
        phase("K1-tile", dtype="float32", B=1003, bt=bt, stages=lay.stages,
              rel_err=f"{rel:.3e}", tol=1e-4, frozen_lane_bitwise=frozen)
        require(rel <= 1e-4 and frozen, f"K1 float32 forced tile {bt}")
    return res


L2_PROBE_SRC = r"""
#include <cuda_runtime.h>
// every thread sums float4s of a buffer that fits the L2, `reps` times over,
// through the L2-only path (ld.global.cg)
__global__ void l2_read(const float4* __restrict__ buf, int n4, int reps, float* out) {
  float a = 0.f, b = 0.f, c = 0.f, d = 0.f;
  for (int r = 0; r < reps; ++r)
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n4; i += gridDim.x * blockDim.x) {
      const float4 v = __ldcg(buf + i);
      a += v.x; b += v.y; c += v.z; d += v.w;
    }
  if (a + b + c + d == 1234.5f) out[0] = a;
}
extern "C" int l2_probe(const void* buf, int n4, int reps, void* out, int blocks,
                        int threads, void* stream) {
  l2_read<<<blocks, threads, 0, (cudaStream_t)stream>>>((const float4*)buf, n4, reps,
                                                         (float*)out);
  return (int)cudaGetLastError();
}
"""


def l2_read_rate(torch, mb=24, reps=20):
    """The card's L2 read rate (bytes/s): a probe kernel built here reads a
    ``mb`` MB buffer (resident in the 50 MB L2 after a first pass) ``reps``
    times over with 16-byte L2-only loads, 8 blocks of 256 threads an SM."""
    import ctypes
    b = _build_mod()
    out_dir = b.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "l2_probe.cu"
    src.write_text(L2_PROBE_SRC)
    lib_path = out_dir / "l2_probe.so"
    subprocess.run([b.find_nvcc(), *b.NVCC_FLAGS, "-shared", "-o", str(lib_path), str(src)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.l2_probe.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                             ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.l2_probe.restype = ctypes.c_int
    buf = torch.ones(mb * 2 ** 20 // 4, dtype=torch.float32, device="cuda")
    out = torch.zeros(1, dtype=torch.float32, device="cuda")
    blocks = 8 * torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        require(lib.l2_probe(buf.data_ptr(), buf.numel() // 4, reps, out.data_ptr(), blocks,
                             256, stream) == 0, "L2 probe launch")

    ms = cuda_ms(torch, run, reps=5)
    return reps * buf.numel() * 4 / (ms * 1e-3)


def k1_l2_bytes(lay, n, m, k_iters, refine, elem):
    """Bytes of the shared matrices a K1 launch reads from L2, reckoned from
    its layout: every block streams its matrices once per use.  Staged tier:
    A k_iters + 1 times, Minv (and M, Minv) once an iteration; stream tier:
    A and its transposed copy, Minv (and M, Minv) once an iteration."""
    nn = (3 if refine else 1) * n * n
    if lay.tier == 0:
        return lay.grid * k_iters * (2 * m * n + nn) * elem
    return lay.grid * ((k_iters + 1) * m * n + k_iters * nn) * elem


# K1 before the staged tier, the stream tier alone (PERF.md, step 0)
K1_MS_BEFORE = {"float32_B16384": 6.5703, "float64_B16384": 11.9478,
                "float32_B1024": 0.8575}


def phase_k1_speed(torch, admm_fused, card, sweep=False):
    """K1's time at the quadrotor shape (n=216, m=535, 10 iterations, CUDA
    events), float32 with refinement and float64 without, at the main path's
    batches (16384, the compacted 1024, and 1, the goldens); the plain
    twin's time at B=16384 float32; the bound and what sets it; the time
    before the staged tier; the layout; float32 at
    each batch also with each tier forced (the staged tier at the tile its
    cost model picks); registers and spills of each kernel from ``-Xptxas
    -v``; the L2 bytes a launch reckoned from the layout and the rate they
    were read at; one 8-lane staged tile alone (its us per iteration from
    10 and 20 iterations).  ``sweep`` (``--sweep-k1``) adds a ``K1-sweep``
    line: the probe's L2 read rate, both tiers at B=2048 and 4096, every
    staged tile at B=16384 and 1024, and each ring depth at 1024.  Returns
    the kernels line's numbers."""
    f32, f64 = torch.float32, torch.float64
    data = {B: k1_problem(B, N_QP, M_QP, seed=0 if B == B_MAIN else 1) for B in (B_MAIN, 1024)}

    def args_of(B, dtype):
        d = data[B] if B in data else k1_problem(B, N_QP, M_QP, seed=2)
        t = {k: torch.as_tensor(v, dtype=dtype, device="cuda")
             for k, v in d.items() if k != "sigma"}
        zeros = lambda w: torch.zeros((B, w), dtype=dtype, device="cuda")
        return (zeros(N_QP), zeros(M_QP), zeros(M_QP),
                torch.zeros(B, dtype=torch.bool, device="cuda"),
                t["q"], t["l"], t["u"], t["A"], t["M"], t["Minv"], t["rho"])

    def time(B, dtype, k_iters=10, reps=10, lay=None):
        a = args_of(B, dtype)
        kw = dict(sigma=1e-5, alpha=1.6, k_iters=k_iters, refine=dtype == f32)
        if lay is None:
            return cuda_ms(torch, lambda: admm_fused.fused_iterations(*a, **kw), reps=reps)
        return cuda_ms(torch, lambda: admm_fused.launch(lay, *a, **kw), reps=reps)

    def tiers(B):
        return (time(B, f32, reps=5, lay=admm_fused.staged_layout(B, N_QP, M_QP)),
                time(B, f32, reps=5, lay=admm_fused.stream_layout(B, N_QP, M_QP, f32)))

    cases = ((B_MAIN, f32), (B_MAIN, f64), (1024, f32), (1024, f64), (1, f32), (1, f64))
    ms = {c: time(*c) for c in cases}
    a = args_of(B_MAIN, f32)
    plain = cuda_ms(torch, lambda: admm_fused.plain_iterations(
        *a, sigma=1e-5, alpha=1.6, k_iters=10, refine=True))
    bound, by = k1_bound_ms(B_MAIN, N_QP, M_QP, 10)
    lays = {c: admm_fused.layout(c[0], N_QP, M_QP, c[1]) for c in cases}
    l2 = {c: k1_l2_bytes(lays[c], N_QP, M_QP, 10, c[1] == f32, 4 if c[1] == f32 else 8)
          for c in cases}
    both = {c: tiers(c[0]) for c in cases if c[1] == f32}
    tile8 = admm_fused.staged_layout(8, N_QP, M_QP, 8)
    alone = (time(8, f32, 20, reps=5, lay=tile8) - time(8, f32, 10, reps=5, lay=tile8)) * 1e2
    log = _build_mod().build_info.get("log", "")
    fmt = lambda r: (f"{r.get('registers')}/{r.get('spill_stores')}/{r.get('spill_loads')}"
                     if r else "not measured")
    regs = {}
    for kern in ("admm_staged_kernel", "admm_stream_kernel"):
        for key, r in kernel_resources(log, kern, by_tile=True).items():
            regs[f"{kern.split('_')[1]}_{key}"] = fmt(r)
    name = lambda c: f"{str(c[1]).split('.')[-1]}_B{c[0]}"
    phase("K1-speed", card=repr(card), shape=f"n={N_QP},m={M_QP},k_iters=10",
          **{f"ms_{name(c)}": f"{ms[c]:.4f}" for c in cases},
          plain_ms_float32_B16384=f"{plain:.4f}",
          ms_before_float32_B16384=K1_MS_BEFORE["float32_B16384"],
          ms_before_float64_B16384=K1_MS_BEFORE["float64_B16384"],
          ms_before_float32_B1024=K1_MS_BEFORE["float32_B1024"],
          bound_ms=f"{bound:.4f}", bound_by=by,
          **{f"layout_{name(c)}": k1_layout(admm_fused, c[0], c[1]) for c in cases},
          ms_staged_vs_stream="/".join(f"{name(c)}:{v[0]:.4f}:{v[1]:.4f}"
                                       for c, v in both.items()),
          **{f"l2_GB_{name(c)}": f"{l2[c] / 1e9:.3f}" for c in cases[:3]},
          **{f"l2_TBps_{name(c)}": f"{l2[c] / ms[c] / 1e9:.3f}" for c in cases[:3]},
          us_per_iteration_one_8_lane_tile=f"{alone:.3f}",
          regs_spill_st_ld=";".join(f"{k}={v}" for k, v in sorted(regs.items())))
    if sweep:
        by_tile = {}
        for t_ in admm_fused.STAGED_TILES:
            lay16k = admm_fused.staged_layout(B_MAIN, N_QP, M_QP, t_)
            if lay16k is not None:
                by_tile[t_] = (time(B_MAIN, f32, reps=5, lay=lay16k),
                               time(1024, f32, lay=admm_fused.staged_layout(1024, N_QP, M_QP, t_)))
        by_stages = {}
        for ns in range(2, admm_fused.MAX_STAGES + 1):
            lay = admm_fused.staged_layout(1024, N_QP, M_QP, 8, ns)
            if lay is not None:
                by_stages[ns] = time(1024, f32, lay=lay)
        more = {B: tiers(B) for B in (2048, 4096)}
        phase("K1-sweep", card=repr(card), l2_probe_TBps=f"{l2_read_rate(torch) / 1e12:.3f}",
              ms_float32_staged_vs_stream="/".join(f"B{B}:{v[0]:.4f}:{v[1]:.4f}"
                                                   for B, v in more.items()),
              ms_float32_staged_by_tile_B16384="/".join(f"{k}:{v[0]:.4f}"
                                                        for k, v in by_tile.items()),
              ms_float32_staged_by_tile_B1024="/".join(f"{k}:{v[1]:.4f}"
                                                       for k, v in by_tile.items()),
              ms_float32_B1024_bt8_by_stages="/".join(f"{k}:{v:.4f}"
                                                      for k, v in by_stages.items()))
    return dict(ms=ms[(B_MAIN, f32)], plain_ms=plain, bound_ms=bound, bound_by=by,
                library_ms=None, ms_float64=ms[(B_MAIN, f64)], ms_B1024=ms[(1024, f32)])


def phase_k2(torch, batched_linalg):
    res = {}
    C64 = spd_batch(B_MAIN, 24)
    Ct64 = torch.as_tensor(C64, device="cuda")
    eye = torch.eye(24, dtype=torch.float64, device="cuda")
    for dtype, tol in ((torch.float32, 1e-4), (torch.float64, 1e-10)):
        C = Ct64.to(dtype)
        inv_k = batched_linalg.chol_inverse(C)
        inv_t = batched_linalg.chol_inverse_plain(C)
        torch.cuda.synchronize()
        absmax = (inv_k - inv_t).abs().max().item()
        rel = absmax / inv_t.abs().max().item()
        resid = (C.double() @ inv_k.double() - eye).abs().amax(dim=(1, 2)).max().item()
        name = str(dtype).split(".")[-1]
        rtol = 1e-3 if dtype == torch.float32 else 1e-8
        phase("K2", dtype=name, shape=f"({B_MAIN},24,24)", rel_err=f"{rel:.3e}",
              max_abs_err=f"{absmax:.3e}", tol=tol,
              resid_inf=f"{resid:.3e}", resid_tol=rtol)
        require(rel <= tol, f"K2 {name} within {tol} of its twin")
        require(resid <= rtol, f"K2 {name} ||C Cinv - I|| <= {rtol}")
        res[name] = absmax
    # a ragged block: the batch is not a multiple of the warps per block
    C = torch.as_tensor(spd_batch(1001, 24, seed=2), dtype=torch.float32, device="cuda")
    rel = ((batched_linalg.chol_inverse(C) - batched_linalg.chol_inverse_plain(C))
           .abs().max() / batched_linalg.chol_inverse_plain(C).abs().max()).item()
    phase("K2-ragged", dtype="float32", B=1001, rel_err=f"{rel:.3e}", tol=1e-4)
    require(rel <= 1e-4, "K2 ragged float32")
    return res


def run_closed_loop(torch, c, x0, noise, Ad_t, Bd_t):
    """16 closed-loop steps: cold first step, then warm steps with the plant
    = model + noise.  Returns per-step (status, solver_status, iters, cmd)."""
    x = x0
    u = torch.zeros((x0.shape[0], 4), dtype=x0.dtype, device=x0.device)
    steps = []
    for k in range(noise.shape[0]):
        r = c.optimize(x, u)
        steps.append((r.status, r.solver_status, c._last_iters, r.cmd))
        u = r.cmd
        x = x @ Ad_t.T + u @ Bd_t.T + noise[k]
    return steps


def phase_main(torch, lt, mods):
    dev = "cuda"
    f32 = torch.float32
    Ad, Bd = quadrotor_model()
    Ad_t = torch.as_tensor(Ad, dtype=f32, device=dev)
    Bd_t = torch.as_tensor(Bd, dtype=f32, device=dev)
    x0_h, noise_h = closed_loop_inputs(B_MAIN, K_MAIN)
    x0 = torch.as_tensor(x0_h, dtype=f32, device=dev)
    noise = torch.as_tensor(noise_h, dtype=f32, device=dev)
    c = quadrotor_controller(lt, f32, dev, closed_loop_params(lt))

    k1 = mods[0].fused_iterations
    k1.trace = []
    reset_counts(*mods)
    t0 = time.perf_counter()
    steps = run_closed_loop(torch, c, x0, noise, Ad_t, Bd_t)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(*mods)
    by_batch = {}
    for B, lay in k1.trace:
        by_batch[(B, lay.bt)] = by_batch.get((B, lay.bt), 0) + 1
    k1.trace = None
    phase("K1-launches", path="lmpc", launches=launches["admm_fused"],
          by_batch="/".join(f"B{B}:{n_}" for (B, _), n_ in sorted(by_batch.items())),
          tiles="/".join(f"B{B}:bt{bt}" for B, bt in sorted(by_batch)))
    require(sum(by_batch.values()) == launches["admm_fused"], "K1 trace counts every launch")
    launches["admm_fused_by_batch"] = {B: n_ for (B, _), n_ in by_batch.items()}

    status = torch.stack([s[0] for s in steps], 1).cpu().numpy()  # (B, K)
    solver = torch.stack([s[1] for s in steps], 1).cpu().numpy()
    iters = torch.stack([s[2] for s in steps], 1).cpu().numpy()
    cmds = torch.stack([s[3] for s in steps], 1)
    require(tuple(cmds.shape) == (B_MAIN, K_MAIN, 4), "cmd shape (B, K, 4)")
    ok = status == int(lt.ResultStatus.SUCCESS)
    require(bool(torch.isfinite(cmds).all().item()), "commands finite")
    for k in range(K_MAIN):
        mix = {int(v): int(n) for v, n in zip(*np.unique(solver[:, k], return_counts=True))}
        phase("main-step", k=k, osqp_status_mix=json.dumps(mix).replace(" ", ""),
              iters_mean=f"{iters[:, k].mean():.2f}",
              iters_p99=f"{np.quantile(iters[:, k], 0.99):.1f}",
              iters_max=int(iters[:, k].max()))
    others = {lt.ResultStatus(int(v)).name: int(n)
              for v, n in zip(*np.unique(status[~ok], return_counts=True))}
    frac = float(ok.mean())
    phase("main", dtype="float32", B=B_MAIN, steps=K_MAIN,
          success_frac=f"{frac:.6f}", non_success=json.dumps(others).replace(" ", ""),
          iters_mean=f"{iters.mean():.2f}", iters_p99=f"{np.quantile(iters, 0.99):.1f}",
          iters_max=int(iters.max()), cold_iters_mean=f"{iters[:, 0].mean():.2f}",
          warm_iters_mean=f"{iters[:, 1:].mean():.2f}",
          warm_iters_p99=f"{np.quantile(iters[:, 1:], 0.99):.1f}",
          launches_admm_fused=launches["admm_fused"],
          launches_chol_inverse=launches["chol_inverse"],
          launches_qp_inner=launches["qp_inner"],
          wall_s=f"{wall:.3f}")
    require(launches["admm_fused"] > 0, "main path launched K1")
    require(launches["chol_inverse"] > 0, "main path launched K2")
    require(frac >= 0.999, f"success fraction {frac} >= 0.999")
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())
    require(tf32 == (False, False, "highest"), f"TF32 off after the solve, got {tf32}")

    # the float32 golden: one unbatched cold solve from x0 = 0, u = 0
    cg = quadrotor_controller(lt, f32, dev, closed_loop_params(lt))
    r = cg.optimize(np.zeros(12), np.zeros(4))
    cmd = r.cmd.cpu().numpy()
    err = float(np.abs(cmd - GOLDEN_CMD).max())
    phase("golden-f32", cmd=np.array2string(cmd, precision=6, separator=","),
          err=f"{err:.3e}", tol=1e-4, iters=int(cg._last_iters))
    require(r.cmd.shape == (4,) and err <= 1e-4, "float32 golden within 1e-4")
    return launches, c


def phase_matched(torch, lt):
    ref = np.load(ROOT / "misc" / "results" / "closed_loop_ref_f64.npz")
    states, inputs = ref["states"], ref["inputs"]  # (B, K+1, 12), (B, K, 4)
    B0, K0 = inputs.shape[:2]
    c = quadrotor_controller(lt, torch.float32, "cuda", closed_loop_params(lt))
    errs = []
    for k in range(K0):
        last_u = inputs[:, k - 1] if k else np.zeros((B0, 4))
        r = c.optimize(states[:, k], last_u)
        errs.append(np.abs(r.cmd.cpu().numpy() - inputs[:, k]).max(axis=-1))
    err = np.stack(errs, 1)  # (B, K)
    warm = err[:, 1:]
    p99 = float(np.quantile(warm, 0.99))
    phase("matched", B=B0, K=K0, cold_mean=f"{err[:, 0].mean():.3e}",
          cold_max=f"{err[:, 0].max():.3e}", warm_mean=f"{warm.mean():.3e}",
          warm_p99=f"{p99:.3e}", warm_max=f"{warm.max():.3e}", tol_p99=1e-4)
    require(p99 <= 1e-4, f"matched-state warm p99 {p99} <= 1e-4")


def phase_golden_f64(torch, lt, admm_fused, batched_linalg):
    golden = np.load(ROOT / "tests" / "golden_trajectories.npz")["quadrotor_cmds"]
    Ad, Bd = quadrotor_model()
    c = quadrotor_controller(lt, torch.float64, "cuda",
                             lt.LParameters(maximum_iteration=250))
    k1, k2 = admm_fused.fused_iterations.launches, batched_linalg.chol_inverse.launches
    x, u = np.zeros(12), np.zeros(4)
    worst = 0.0
    for k in range(20):
        u = c.optimize(x, u).cmd.cpu().numpy()
        worst = max(worst, float(np.abs(u - golden[k]).max()))
        x = Ad @ x + Bd @ u
    k1 = admm_fused.fused_iterations.launches - k1
    k2 = batched_linalg.chol_inverse.launches - k2
    phase("golden-f64", steps=20, max_err=f"{worst:.3e}", tol=1e-6,
          launches_admm_fused=k1, launches_chol_inverse=k2)
    require(worst <= 1e-6, "float64 20-step golden within 1e-6")
    require(k1 > 0 and k2 > 0, "float64 golden ran through both kernels")


def _bound(words, flops):
    t_bytes, t_ops = 4 * words / PEAK_BYTES, flops / PEAK_FLOPS_F32
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def k1_bound_ms(B, n, m, k_iters):
    """Least time for one K1 block, float32 with refinement.  Bytes: x, q
    (B n each), z, y, l, u (B m each), A (m n), M and Minv (n n each), rho
    (m) read once, x, z, y written once.  Operations per lane-iteration: two
    products with A (4 m n), one with M and two with Minv (6 n^2)."""
    words = B * (2 * n + 4 * m) + m * n + 2 * n * n + m + B * (n + 2 * m)
    return _bound(words, B * k_iters * (4 * m * n + 6 * n * n))


def lower_triangle_bytes(B, k, elem):
    """Bytes in the 32-byte sectors that hold the lower triangles of a
    contiguous batch of B k x k matrices (row r's positions 0..r), the
    least an SPD inverse by Cholesky reads of its input."""
    start = (np.arange(B, dtype=np.int64)[:, None] * k * k
             + np.arange(k, dtype=np.int64)[None, :] * k).ravel()
    first = start * elem // SECTOR_BYTES
    last = ((start + np.tile(np.arange(k, dtype=np.int64), B) + 1) * elem - 1) // SECTOR_BYTES
    sectors = int((last - first + 1).sum() - (first[1:] == last[:-1]).sum())
    return sectors * SECTOR_BYTES


def k2_bound_ms(B, k, elem=4):
    """Least time for K2: the lower triangles in (at the sectors'
    granularity, :func:`lower_triangle_bytes`) and B k^2 elements out; k^3
    operations per matrix (k^3/3 for the factor, 2 k^3/3 for the inverse),
    at the float32 peak for float32 (``elem`` 4) and the float64 one for
    float64."""
    t_bytes = (lower_triangle_bytes(B, k, elem) + B * k * k * elem) / PEAK_BYTES
    t_ops = B * k ** 3 / (PEAK_FLOPS_F32 if elem == 4 else PEAK_FLOPS_F64)
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


# -- the Van der Pol NLMPC of examples/vanderpol_ex.cpp (bench.py:444-480) -----
def vdp(x, u, k):
    import torch
    return torch.stack([(1.0 - x[1] * x[1]) * x[0] - x[1] + u[0], x[0]])


def vdp_controller(lt, dtype, device, params):
    import torch
    c = lt.NLMPC(2, 1, 2, 10, 5, 11, 0, dtype=dtype, device=device)
    c.set_discretization_sampling_time(0.1)
    c.set_optimizer_parameters(params)
    c.set_state_space_function(vdp)
    c.set_objective_function(lambda X, Y, U, e: torch.sum(X**2) + torch.sum(U**2))
    c.set_ineq_con_function(lambda X, Y, U, e: U[:, 0] - 0.5)
    return c


def vdp_params(lt):
    return lt.NLParameters(maximum_iteration=30, enable_warm_start=True,
                           inner_qp="fused", hessian_reg="gershgorin")


def vdp_closed_loop_inputs(B, K):
    """bench.py:437-441."""
    rng = np.random.default_rng(11)
    x0 = rng.uniform(-1.0, 1.0, size=(B, 2))
    noise = 0.01 * rng.normal(size=(K, B, 2))
    return x0, noise


def vdp_plant(torch, noise):
    """bench.py:475-476: x + 0.1 f(x, u) + noise[k]."""
    f = torch.func.vmap(vdp, in_dims=(0, 0, None))
    return lambda x, u, k: x + 0.1 * f(x, u, k) + noise[k]


def vdp_qps(B, seed, spread=0.05):
    """First-iteration SQP subproblems of the Van der Pol NLMPC (ph=10, ch=5,
    h = Ts/2 = 0.05), linearized with numpy at trajectories scattered around a
    random initial state, in the form ops/sqp.py builds them: equality rows
    (the defect Jacobian), one-sided rows with -inf (the input limit), identity
    box rows (all infinite but the pinned slack), the Gershgorin-shifted
    Hessian, and rho per row from the masks.  float64; cast by the caller."""
    rng = np.random.default_rng(seed)
    ph, ch, nx, h = 10, 5, 2, 0.05
    n, me, mi, m = N_NL, ME_NL, MI_NL, M_NL
    x0 = rng.uniform(-1.0, 1.0, size=(B, nx))
    X = np.concatenate(
        [x0[:, None, :], x0[:, None, :] + spread * rng.normal(size=(B, ph, nx))], 1)
    ub = spread * rng.normal(size=(B, ch))
    blk = np.minimum(np.arange(ph + 1), ch - 1)
    U = ub[:, blk]  # (B, ph+1)

    def f(x, u):
        return np.stack([(1 - x[..., 1] ** 2) * x[..., 0] - x[..., 1] + u, x[..., 0]], -1)

    def jac(x):
        J = np.zeros(x.shape[:-1] + (2, 2))
        J[..., 0, 0] = 1 - x[..., 1] ** 2
        J[..., 0, 1] = -2 * x[..., 0] * x[..., 1] - 1
        J[..., 1, 0] = 1.0
        return J

    ce = (X[:, :-1] + h * (f(X[:, :-1], U[:, :-1]) + f(X[:, 1:], U[:, :-1]))
          - X[:, 1:]).reshape(B, me)
    Je = np.zeros((B, me, n))
    for k in range(ph):
        r = slice(2 * k, 2 * k + 2)
        if k > 0:
            Je[:, r, 2 * (k - 1):2 * k] = np.eye(2) + h * jac(X[:, k])
        Je[:, r, 2 * k:2 * k + 2] = h * jac(X[:, k + 1]) - np.eye(2)
        Je[:, 2 * k, me + blk[k]] = 2 * h
    Ji = np.zeros((B, mi, n))
    Ji[:, np.arange(mi), me + blk] = 1.0
    ci = U - 0.5
    hdiag = np.concatenate([np.full(me, 2.0), 2.0 * np.bincount(blk, minlength=ch), [0.0]])
    tau = max(1e-6 * hdiag.max(), 1e-8)
    P = np.broadcast_to(np.diag(hdiag + tau), (B, n, n)).copy()
    z = np.concatenate([X[:, 1:].reshape(B, me), ub, np.zeros((B, 1))], 1)
    lb = np.full(n, -1e20)
    ubd = np.full(n, 1e20)
    lb[-1] = ubd[-1] = 0.0
    A = np.concatenate([Je, Ji, np.broadcast_to(np.eye(n), (B, n, n))], 1)
    l = np.concatenate([-ce, np.full((B, mi), -np.inf), lb - z], 1)
    u = np.concatenate([-ce, -ci, ubd - z], 1)
    loose = (l <= -1e18) & (u >= 1e18)
    rho = np.where(loose, 1e-6, np.where(np.arange(m) < me, 100.0, 0.1))
    return P, A, hdiag * z, l, u, rho


def hist25(iters):
    """Iteration counts as a histogram over check blocks of 25."""
    c = np.bincount(np.asarray(iters).reshape(-1) // 25)
    return json.dumps({int(25 * i): int(v) for i, v in enumerate(c) if v}).replace(" ", "")


def phase_k2_nlmpc(torch, batched_linalg):
    """K2 at the shapes the NLMPC paths give it: the second-order-correction
    system (me = 20) and the interior point's barrier system (nz + 1 = 27) of
    Van der Pol, and the oscillators' border Schur complement (w = 8) at the
    main path's batch, in both types, and at a rescue-sized ragged batch.
    Returns the largest float32 error at the oscillators' batch."""
    res = {}
    f32, f64 = torch.float32, torch.float64
    for B, k, dtype, tol, seed in ((B_NL, ME_NL, f32, 1e-4, 3), (1024, N_NL + 1, f64, 1e-10, 4),
                                   (B_OSC, W_O, f32, 1e-4, 5), (B_OSC, W_O, f64, 1e-10, 5),
                                   (37, W_O, f32, 1e-4, 6)):
        C = torch.as_tensor(spd_batch(B, k, seed=seed), dtype=dtype, device="cuda")
        inv_k = batched_linalg.chol_inverse(C)
        inv_t = batched_linalg.chol_inverse_plain(C)
        torch.cuda.synchronize()
        absmax = (inv_k - inv_t).abs().max().item()
        rel = absmax / inv_t.abs().max().item()
        name = str(dtype).split(".")[-1]
        phase("K2-nlmpc", dtype=name, shape=f"({B},{k},{k})", rel_err=f"{rel:.3e}",
              max_abs_err=f"{absmax:.3e}", tol=tol)
        require(rel <= tol, f"K2 {name} ({B},{k},{k}) within {tol} of its twin")
        if (B, k, dtype) == (B_OSC, W_O, f32):
            res["osc_float32"] = absmax
    return res


def k3_qps(B, seed=0, n=N_NL, me=ME_NL, mi=MI_NL, box=True):
    """Feasible QPs in the SQP's form, float64: ``me`` equality rows,
    ``mi`` one-sided rows with -inf, and (``box``) ``n`` identity box rows
    of which some are infinite; rho per row from the masks with a mild
    equality penalty (1.0), so that float32 rounding is not amplified.
    Returns P, A, q, l, u, rho."""
    rng = np.random.default_rng(seed)
    Q = rng.normal(size=(B, n, n))
    P = Q @ Q.transpose(0, 2, 1) / n + 0.5 * np.eye(n)
    Aei = rng.normal(size=(B, me + mi, n)) / np.sqrt(n)
    v = np.einsum("brn,bn->br", Aei, rng.uniform(-0.4, 0.4, size=(B, n)))
    l = [v[:, :me], np.full((B, mi), -np.inf)]
    u = [v[:, :me], v[:, me:] + 0.2 * np.abs(rng.normal(size=(B, mi)))]
    A = [Aei]
    if box:
        lo, hi = np.full((B, n), -0.5), np.full((B, n), 0.5)
        lo[:, ::3], hi[:, 1::3] = -1e20, 1e20
        l, u, A = l + [lo], u + [hi], A + [np.broadcast_to(np.eye(n), (B, n, n))]
    l, u, A = (np.concatenate(a, axis=1) for a in (l, u, A))
    m = A.shape[1]
    loose = (l <= -1e18) & (u >= 1e18)
    rho = np.where(loose, 1e-6, np.where(np.arange(m) < me, 1.0, 0.1))
    return [P, A, 0.2 * rng.normal(size=(B, n)), l, u, rho]


def k3_tier(qpf, n, m):
    """K3's layout for an (n, m) subproblem (a kernel with one layout for
    every shape, as before the register tier, reads as "shared")."""
    return qpf.tier(n, m) if hasattr(qpf, "tier") else "shared"


def k3_scaled_args(torch, qpf, data, dtype):
    """The kernel's own inputs: ``data`` (P, A, q, l, u, rho) Ruiz-scaled as
    ``solve_batched`` scales them, from a cold start."""
    t = [torch.as_tensor(a, dtype=dtype, device="cuda") for a in data]
    B, m, n = t[1].shape
    x0 = torch.zeros((B, n), dtype=dtype, device="cuda")
    y0 = torch.zeros((B, m), dtype=dtype, device="cuda")
    Ps, As, qs, ls, us, xs, ys, d, e, c = qpf._scale_problem(*t[:5], x0, y0, 10)
    return (Ps, As, qs, ls, us, t[5], xs, ys, 1.0 / d, 1.0 / e, 1.0 / c)


def k3_refactorizations(torch, qpf, args, kw):
    """Refactorizations the kernel makes on these scaled inputs after the
    first factorization, counted on the twin: each time the twin factors
    the batch again, the lanes whose KKT matrix changed (a lane whose rho
    did not move gets the same matrix bit for bit).  The twin, like the
    TPU kernel, also refactors after the last check block, which the CUDA
    kernel does not; those are left out.  Counted by watching the twin's
    calls of ``torch.linalg.cholesky_ex`` and the count of its host reads
    (``_host.reads``: two a check block until the last); the twin itself
    is not changed."""
    real = torch.linalg.cholesky_ex
    host = qpf._host
    n_blocks = max(1, (kw["max_iter"] + kw["check_every"] - 1) // kw["check_every"])
    prev, moves, start = [None], [0], host.reads

    def watch(M, *a, **k):
        if prev[0] is not None and (host.reads - start) // 2 < n_blocks:
            moves[0] += int((M != prev[0]).flatten(1).any(1).sum().item())
        prev[0] = M.clone()
        return real(M, *a, **k)

    torch.linalg.cholesky_ex = watch
    try:
        qpf._iterate_plain(*args, **kw)
    finally:
        torch.linalg.cholesky_ex = real
    return moves[0]


def k3_case(torch, qpf, data, dtype, **kw):
    """Kernel and twin on the same QPs from a cold start."""
    t = [torch.as_tensor(a, dtype=dtype, device="cuda") for a in data]
    B = t[0].shape[0]
    x0 = torch.zeros((B, N_NL), dtype=dtype, device="cuda")
    y0 = torch.zeros((B, M_NL), dtype=dtype, device="cuda")
    out_k = qpf.solve_batched(*t, x0, y0, **kw)
    torch.cuda.synchronize()
    out_t = qpf.plain_solve_batched(*t, x0, y0, **kw)
    torch.cuda.synchronize()
    for o in out_k[:3]:
        require(bool(torch.isfinite(o).all().item()), "K3 output finite")
    rel = [((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()
           for a, b in zip(out_k[:3], out_t[:3])]
    absmax = max((a - b).abs().max().item() for a, b in zip(out_k[:3], out_t[:3]))
    return out_k, out_t, rel, absmax


def phase_k3(torch, qpf):
    """K3 against its twin at the path's shape (B=4096, n=26, m=57) and on a
    ragged batch (B=1003).

    float64 is the check of the kernel's logic: ``done`` and the iteration
    count equal on every lane, x/y/z within 1e-9 of their scale.  float32 at
    the path's tolerance (5e-6) iterates at its own rounding floor, so two
    correct float32 evaluations stop some lanes a few check blocks apart
    (the Pallas kernel in interpret mode does the same against the twin);
    there the requirements are: after ONE check block, before any branch,
    x/y/z within 1e-3 of scale on every lane; run to the cap, x and z within
    1e-3 of scale and y within 2e-2 on every lane, and ``done`` equal on at
    least three lanes in four.  Both histograms are printed."""
    res = {}
    for B, seed in ((B_NL, 0), (1003, 1)):
        data = vdp_qps(B, seed)
        tag = "K3" if B == B_NL else "K3-ragged"
        k, t, rel, absmax = k3_case(torch, qpf, data, torch.float64, **K3_KW)
        same_done = bool(torch.equal(k[4], t[4]))
        same_iters = bool(torch.equal(k[3], t[3]))
        phase(tag, dtype="float64", B=B, n=N_NL, m=M_NL, tier=k3_tier(qpf, N_NL, M_NL),
              rel_err_xyz="/".join(f"{r:.2e}" for r in rel), tol=1e-9,
              done_equal=same_done, iters_equal=same_iters,
              done_frac=f"{k[4].float().mean().item():.4f}",
              iters_kernel=hist25(k[3].cpu()), iters_twin=hist25(t[3].cpu()))
        require(max(rel) <= 1e-9, f"{tag} float64 within 1e-9 of its twin")
        require(same_done and same_iters, f"{tag} float64 done and iterations equal on every lane")

        _, _, rel1, _ = k3_case(torch, qpf, data, torch.float32, **dict(K3_KW, max_iter=25))
        k, t, rel, absmax = k3_case(torch, qpf, data, torch.float32, **K3_KW)
        agree = (k[4] == t[4]).float().mean().item()
        phase(tag, dtype="float32", B=B, n=N_NL, m=M_NL,
              one_block_rel_err_xyz="/".join(f"{r:.2e}" for r in rel1),
              rel_err_xyz="/".join(f"{r:.2e}" for r in rel), tol_xz=1e-3, tol_y=2e-2,
              max_abs_err=f"{absmax:.3e}", done_agree=f"{agree:.4f}",
              done_frac_kernel=f"{k[4].float().mean().item():.4f}",
              done_frac_twin=f"{t[4].float().mean().item():.4f}",
              iters_kernel=hist25(k[3].cpu()), iters_twin=hist25(t[3].cpu()))
        require(max(rel1) <= 1e-3, f"{tag} float32 one block within 1e-3 of its twin")
        require(rel[0] <= 1e-3 and rel[2] <= 1e-3 and rel[1] <= 2e-2,
                f"{tag} float32 within tolerance of its twin")
        require(agree >= 0.75, f"{tag} float32 done agrees on >= 3 lanes in 4")
        if B == B_NL:
            res["float32"] = absmax
    return res


def _wrappers(admm_fused, batched_linalg, qpf, ts):
    """The five launch-counting wrappers, by kernel name."""
    return {"admm_fused": admm_fused.fused_iterations,
            "chol_inverse": batched_linalg.chol_inverse,
            "qp_inner": qpf.solve_batched,
            "traj_factor": ts.batched_factor,
            "traj_sweep": ts.batched_sweep_solve}


def reset_counts(*mods):
    for fn in _wrappers(*mods).values():
        fn.launches = 0


def read_counts(*mods):
    return {name: fn.launches for name, fn in _wrappers(*mods).items()}


def phase_main_nlmpc(torch, lt, qpf, host, mods):
    dev, f32 = "cuda", torch.float32
    x0_h, noise_h = vdp_closed_loop_inputs(B_NL, K_NL)
    x0 = torch.as_tensor(x0_h, dtype=f32, device=dev)
    noise = torch.as_tensor(noise_h, dtype=f32, device=dev)
    c = vdp_controller(lt, f32, dev, vdp_params(lt))

    reset_counts(*mods)
    qpf.solve_batched.trace = []
    host.reads = 0
    t0 = time.perf_counter()
    r = lt.nlmpc_rollout(c, vdp_plant(torch, noise), x0,
                         torch.zeros((B_NL, 1), dtype=f32, device=dev), K_NL)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(*mods)
    reads = host.reads
    trace, qpf.solve_batched.trace = qpf.solve_batched.trace, None
    k3_iters = torch.cat([it for it, _ in trace]).cpu().numpy()
    k3_done = torch.cat([d for _, d in trace]).float().mean().item()

    require(tuple(r.inputs.shape) == (B_NL, K_NL, 1), "inputs shape (B, K, 1)")
    require(tuple(r.states.shape) == (B_NL, K_NL + 1, 2), "states shape (B, K+1, 2)")
    require(bool(torch.isfinite(r.inputs).all().item()), "commands finite")
    status = r.statuses.cpu().numpy()
    iters = r.iterations.cpu().numpy()
    for k in range(K_NL):
        phase("nlmpc-step", k=k, sqp_iters_mean=f"{iters[:, k].mean():.2f}",
              sqp_iters_max=int(iters[:, k].max()),
              success_frac=f"{(status[:, k] == 0).mean():.6f}")
    mix = {lt.ResultStatus(int(v)).name: int(n)
           for v, n in zip(*np.unique(status, return_counts=True))}
    frac = float((status == 0).mean())
    cmd_max = r.inputs.max().item()
    phase("main-nlmpc", dtype="float32", B=B_NL, steps=K_NL, success_frac=f"{frac:.6f}",
          status_mix=json.dumps(mix).replace(" ", ""),
          sqp_iters_mean=f"{iters.mean():.2f}",
          sqp_iters_p99=f"{np.quantile(iters, 0.99):.1f}", sqp_iters_max=int(iters.max()),
          k3_iters=hist25(k3_iters), k3_iters_mean=f"{k3_iters.mean():.1f}",
          k3_done_frac=f"{k3_done:.4f}", cmd_max=f"{cmd_max:.7f}",
          launches_qp_inner=launches["qp_inner"],
          launches_chol_inverse=launches["chol_inverse"],
          launches_admm_fused=launches["admm_fused"],
          host_reads=reads, host_reads_per_step=f"{reads / K_NL:.1f}",
          wall_s=f"{wall:.3f}")
    require(launches["qp_inner"] > 0, "NLMPC main path launched K3")
    require(launches["chol_inverse"] > 0, "NLMPC main path launched K2")
    require(frac >= 0.999, f"NLMPC success fraction {frac} >= 0.999")
    require(cmd_max <= 0.5 + 1e-5, f"commands never above 0.5 + 1e-5 (max {cmd_max})")
    return launches


def phase_matched_nlmpc(torch, lt):
    """bench.py:540-558: the plant is teleported onto the float64 oracle's
    states, so every step solves the oracle's own problem."""
    ref = np.load(ROOT / "misc" / "results" / "vdp_closed_loop_ref_f64.npz")
    B0, K0 = int(ref["B"]), int(ref["K"])
    ostates = torch.as_tensor(ref["states"], dtype=torch.float32, device="cuda")
    c = vdp_controller(lt, torch.float32, "cuda", vdp_params(lt))
    r = lt.nlmpc_rollout(c, lambda x, u, k: ostates[:, k + 1], ostates[:, 0],
                         torch.zeros((B0, 1), dtype=torch.float32, device="cuda"), K0)
    err = np.abs(r.inputs.cpu().numpy().astype(np.float64) - ref["inputs"]).max(axis=-1)
    warm = err[:, 1:]
    mean, p99, worst = float(warm.mean()), float(np.quantile(warm, 0.99)), float(warm.max())
    phase("matched-nlmpc", B=B0, K=K0, cold_mean=f"{err[:, 0].mean():.3e}",
          cold_max=f"{err[:, 0].max():.3e}", warm_mean=f"{mean:.3e}",
          warm_p99=f"{p99:.3e}", warm_max=f"{worst:.3e}", tol_mean=1e-4, tol_p99=1e-3,
          tol_max=1e-2, success_frac=f"{(r.statuses == 0).float().mean().item():.6f}")
    require(mean <= 1e-4, f"NLMPC matched-state warm mean {mean} <= 1e-4")
    require(p99 <= 1e-3, f"NLMPC matched-state warm p99 {p99} <= 1e-3")
    require(worst <= 1e-2, f"NLMPC matched-state warm max {worst} <= 1e-2")


def phase_golden_f64_nlmpc(torch, lt, mods):
    """tests/test_golden_trajectories.py::test_vdp_20_step_commands on the
    card: float64, so the fused request runs the banded-KKT interior point
    (K4, K5 and K2 in float64), as it does in the JAX package, and the
    second-order correction goes through K2."""
    golden = np.load(ROOT / "tests" / "golden_trajectories.npz")["vdp_cmds"]
    c = vdp_controller(lt, torch.float64, "cuda", lt.NLParameters(maximum_iteration=100))
    before = read_counts(*mods)
    x, u = np.array([0.0, 1.0]), np.zeros(1)
    worst = 0.0
    for k in range(20):
        u = c.optimize(x, u).cmd.cpu().numpy()
        worst = max(worst, float(np.abs(u - golden[k]).max()))
        x = x + 0.1 * np.array([(1.0 - x[1] ** 2) * x[0] - x[1] + u[0], x[0]])
    n = {k: v - before[k] for k, v in read_counts(*mods).items()}
    phase("golden-f64-nlmpc", steps=20, max_err=f"{worst:.3e}", tol=1e-6,
          launches_traj_factor=n["traj_factor"], launches_traj_sweep=n["traj_sweep"],
          launches_chol_inverse=n["chol_inverse"], launches_qp_inner=n["qp_inner"])
    require(worst <= 1e-6, "float64 20-step Van der Pol golden within 1e-6")
    require(n["traj_factor"] > 0 and n["traj_sweep"] > 0 and n["chol_inverse"] > 0
            and n["qp_inner"] == 0,
            "float64 golden ran through the banded engine (K4, K5, K2), not K3")


def k3_bound_ms(iters, n, m, refactorizations=0):
    """Least time for K3's work at these iteration counts, float32.

    Bytes: every input read once (P, A, q, l, u, rho, x0, y0, dinv, einv,
    cinv) and every output written once (x, y, z, iters, done, pri, dua).
    Operations per instance: one factorization, and one for each
    refactorization after a rho move, counted by the caller
    (``k3_refactorizations``: the kernel does not report them); a
    factorization is the assembly of M = P + sigma I + A' diag(rho) A (m n
    scalings of A's rows by rho, then n^2 m multiply-adds, 2 n^2 m
    operations) and its factorization and inverse (n^3).  Per iteration two
    products with A, one with M and two with M^-1 (4 m n + 6 n^2); per check
    Ax, A'y and Px (4 m n + 2 n^2)."""
    iters = np.asarray(iters, dtype=np.float64)
    B = iters.size
    words = B * (n * n + m * n + 3 * n + 5 * m + 1 + n + 2 * m + 4)
    flops = ((B + refactorizations) * (2 * n * n * m + m * n + n ** 3)
             + iters.sum() * (4 * m * n + 6 * n * n)
             + (iters / 25).sum() * (4 * m * n + 2 * n * n))
    return _bound(words, flops)


def family_ms(prof):
    """Device milliseconds by ``mpcbench.trace.family`` (the benchmark's
    kernel families) and the number of device activities, from the CUDA
    rows of a ``torch.profiler`` run (operator rows would count the same
    time twice)."""
    from mpcbench.trace import family

    fam, count = {}, 0
    for ev in prof.key_averages():
        if str(ev.device_type).endswith("CUDA"):
            key = family(ev.key)
            fam[key] = fam.get(key, 0.0) + ev.self_device_time_total / 1e3
            count += ev.count
    return fam, count


def profile_loop(torch, host, tag, c, plant, x, u, warm_from, warm_steps):
    """Device time by kernel family over the cold step and over
    ``warm_steps`` warm steps of an NLMPC closed loop driven through
    ``optimize`` (CUDA kernel rows of ``torch.profiler`` only), then the
    peak memory of two more steps."""
    from torch.profiler import ProfilerActivity, profile

    c.set_stats_mode("lazy")

    def steps(k0, n, x, u):
        for k in range(k0, k0 + n):
            u = c.optimize(x, u).cmd
            x = plant(x, u, k)
        return x, u

    def window(name, k0, n, x, u):
        host.reads = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            x, u = steps(k0, n, x, u)
            torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
        fam, count = family_ms(prof)
        busy = sum(fam.values())
        phase(name, steps=n, wall_ms_per_step=f"{wall / n:.1f}",
              device_busy_ms_per_step=f"{busy / n:.1f}",
              idle_share=f"{max(0.0, 1 - busy / wall):.3f}",
              kernel_launches_per_step=f"{count / n:.0f}",
              host_reads_per_step=f"{host.reads / n:.1f}",
              sqp_iters_mean=f"{c._last_iters.float().mean().item():.2f}",
              **{k.replace(" ", "_"): f"{v / n:.2f}ms({100 * v / max(busy, 1e-9):.1f}%)"
                 for k, v in fam.items() if v > 0})
        return x, u

    x, u = window(f"profile-{tag}-cold", 0, 1, x, u)
    x, u = steps(1, warm_from - 1, x, u)
    x, u = window(f"profile-{tag}-warm", warm_from, warm_steps, x, u)
    torch.cuda.reset_peak_memory_stats()
    steps(warm_from + warm_steps, 2, x, u)
    torch.cuda.synchronize()
    phase(f"profile-{tag}-memory",
          peak_GiB=f"{torch.cuda.max_memory_allocated() / 2**30:.3f}")


def phase_profile_osc(torch, lt, host):
    """``--profile``: the oscillator loop (B=1024; ``optimize`` steps, so
    without the rollout's rescue phase)."""
    dev, f32 = "cuda", torch.float32
    x0_h, noise_h = osc_inputs(B_OSC, 8)
    noise = torch.as_tensor(noise_h, dtype=f32, device=dev)
    profile_loop(torch, host, "osc", osc_controller(lt, f32, dev, osc_params(lt)),
                 osc_plant(torch, noise), torch.as_tensor(x0_h, dtype=f32, device=dev),
                 torch.zeros((B_OSC, NU_O), dtype=f32, device=dev), warm_from=2, warm_steps=3)


def phase_profile_osc_rollout(torch, lt, tk, host, mods, steps=4):
    """``--profile``: the device's idle share of the oscillator loop from one
    window: ``steps`` steps through ``nlmpc_rollout`` from a cold start, rescue
    included, traced for device activity only (host-side operator records
    slow the host about threefold; kernel records alone cost little), after
    the same window untraced, so that the tracing's cost is printed beside the
    share it was measured under."""
    from torch.profiler import ProfilerActivity, profile

    plain_wall = run_osc(torch, lt, tk, host, mods, B_OSC, steps)[-1]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        *_, reads, wall = run_osc(torch, lt, tk, host, mods, B_OSC, steps)
    fam, count = family_ms(prof)
    busy = sum(fam.values()) / 1e3
    phase("profile-osc-rollout", B=B_OSC, steps=steps, wall_s_traced=f"{wall:.3f}",
          wall_s_untraced=f"{plain_wall:.3f}", tracing_slowdown=f"{wall / plain_wall:.3f}",
          device_busy_s=f"{busy:.3f}", idle_share_traced=f"{1 - busy / wall:.3f}",
          idle_share_against_untraced_wall=f"{1 - busy / plain_wall:.3f}",
          kernel_launches_per_step=f"{count / steps:.0f}",
          host_reads_per_step=f"{reads / steps:.1f}",
          **{k.replace(" ", "_"): f"{v / steps:.1f}ms_per_step"
             for k, v in fam.items() if v > 0})


def k3_latency_us(torch, qpf, args, kw, B):
    """Microseconds per iteration of the first ``B`` instances: tolerances
    of 0 keep every lane iterating to the cap, so (t(300) - t(25)) / 275 is
    the time of one iteration of one warp at that residency (alone on the
    card for B = 1, one per SM for B = the SM count).  Returns (ms at 300
    iterations, ms at 25, us per iteration)."""
    never = dict(kw, eps_abs=0.0, eps_rel=0.0)
    sub = tuple(a[:B].contiguous() for a in args)
    t300 = cuda_ms(torch, lambda: qpf._iterate_kernel(*sub, **never), reps=5)
    t25 = cuda_ms(torch, lambda: qpf._iterate_kernel(*sub, **dict(never, max_iter=25)), reps=5)
    return t300, t25, 1e3 * (t300 - t25) / 275


def phase_sweep_k3(torch, qpf):
    """``--sweep-k3``: K3 alone (CUDA events) at the path's shape for several
    numbers of warps per block, twice in opposite orders within this one
    process.  The kernel gives each instance one warp; how many share a
    block decides how many instances are resident per SM and is the
    kernel's only launch parameter (the register tier takes at most 4)."""
    f32 = torch.float32
    args = k3_scaled_args(torch, qpf, vdp_qps(B_NL, 0), f32)
    kw = dict(K3_KW, refine=True)
    per_warp = qpf.smem_bytes(N_NL, M_NL, f32)
    default, ref = qpf.WARPS_PER_BLOCK, None
    reg = k3_tier(qpf, N_NL, M_NL) == "register"
    settings = (1, 2, 3, 4) if reg else (1, 2, 3, 4, 6, 8, 12)
    try:
        for order in (settings, settings[::-1]):
            for warps in order:
                qpf.WARPS_PER_BLOCK = warps
                ms = cuda_ms(torch, lambda: qpf._iterate_kernel(*args, **kw), reps=10)
                iters = qpf._iterate_kernel(*args, **kw)[3]
                ref = iters if ref is None else ref
                phase("sweep-k3", warps_per_block=warps, block_smem_bytes=warps * per_warp,
                      ms=f"{ms:.4f}", iters_equal=bool(torch.equal(iters, ref)))
    finally:
        qpf.WARPS_PER_BLOCK = default
    # the latency chain of one instance alone on the card, one per SM, and
    # at thirteen per SM
    for B in (1, 132, 132 * 13):
        t300, t25, us = k3_latency_us(torch, qpf, args, kw, B)
        phase("latency-k3", B=B, ms_300_iters=f"{t300:.4f}", ms_25_iters=f"{t25:.4f}",
              us_per_iteration=f"{us:.3f}", ms_setup_and_first_block=f"{t25:.4f}")


def phase_k3_caps(torch, qpf):
    """Float32 lanes that run to the 300-iteration cap, kernel and twin, on
    the timing inputs (``vdp_qps(4096, 0)``) under 8 row permutations and
    on seeds 1 and 2.  The rows of a QP permuted make the same QP summed in
    another order, so the spread over permutations is what float32 rounding
    alone moves; the kernel and its twin differ only in rounding too."""
    kw = dict(K3_KW, refine=True)
    counts = {"kernel": [], "twin": []}
    for seed, k in [(0, k) for k in range(9)] + [(1, 0), (2, 0)]:
        P, A, q, l, u, rho = vdp_qps(B_NL, seed)
        if k:
            p = np.random.default_rng(k).permutation(M_NL)
            A, l, u, rho = A[:, p], l[:, p], u[:, p], rho[:, p]
        args = k3_scaled_args(torch, qpf, [P, A, q, l, u, rho], torch.float32)
        for name, fn in (("kernel", qpf._iterate_kernel), ("twin", qpf._iterate_plain)):
            iters = fn(*args, **kw)[3]
            counts[name].append(int((iters >= kw["max_iter"]).sum().item()))
    phase("K3-caps", dtype="float32", B=B_NL, inputs="seed0+8perms,seed1,seed2",
          **{f"{k}_caps": "/".join(map(str, v)) for k, v in counts.items()},
          **{f"{k}_median": int(np.median(v)) for k, v in counts.items()})
    return counts


K3_SHARED_SHAPE = (N_NL, ME_NL, 138)  # n, me, mi: m = 184, the JAX gate's largest at n = 26


def phase_k3_speed(torch, qpf, card):
    """K3's time at Van der Pol's shape (B=4096, n=26, m=57) on the scaled
    problem (the kernel's own inputs), cold (CUDA events), float32 and
    float64, beside the float32 plain twin's time on the same inputs and
    the float32 ``solve_batched`` with its host-side scaling, its bound
    (with the refactorizations the twin makes on the same inputs), its time
    before the redesign, the registers and spills of each tier and type from
    ``-Xptxas -v``, the tier, the float32 iteration histogram, one
    instance's time per iteration alone and at one instance per SM, and the
    float32 time at a shape of the shared-memory tier (n=26, m=184: k3_qps
    data).  Returns the kernels line's numbers."""
    f32, f64 = torch.float32, torch.float64
    tier = lambda n, m: k3_tier(qpf, n, m)
    kw = dict(K3_KW, refine=True)
    data = vdp_qps(B_NL, 0)
    args = {dt: k3_scaled_args(torch, qpf, data, dt) for dt in (f32, f64)}
    times = {dt: cuda_ms(torch, lambda: qpf._iterate_kernel(*a, **kw), reps=10)
             for dt, a in args.items()}
    plain = cuda_ms(torch, lambda: qpf._iterate_plain(*args[f32], **kw), reps=3, warmup=1)
    t = [torch.as_tensor(a, dtype=f32, device="cuda") for a in data]
    x0 = torch.zeros((B_NL, N_NL), dtype=f32, device="cuda")
    y0 = torch.zeros((B_NL, M_NL), dtype=f32, device="cuda")
    whole = cuda_ms(torch, lambda: qpf.solve_batched(*t, x0, y0, **K3_KW), reps=10)
    iters = qpf._iterate_kernel(*args[f32], **kw)[3].cpu().numpy()
    iters64 = qpf._iterate_kernel(*args[f64], **kw)[3].cpu().numpy()
    refact = k3_refactorizations(torch, qpf, args[f32], kw)
    bound, by = k3_bound_ms(iters, N_NL, M_NL, refact)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    lat = {B: k3_latency_us(torch, qpf, args[f32], kw, B)[2] for B in (1, n_sm)}
    n_s, me_s, mi_s = K3_SHARED_SHAPE
    m_s = me_s + mi_s + n_s
    sh_args = k3_scaled_args(torch, qpf, k3_qps(B_NL, 5, n_s, me_s, mi_s), f32)
    sh_ms = cuda_ms(torch, lambda: qpf._iterate_kernel(*sh_args, **kw), reps=5)
    sh_iters = qpf._iterate_kernel(*sh_args, **kw)[3].float().mean().item()
    log = _build_mod().build_info.get("log", "")
    fmt = lambda r: (f"{r.get('registers')}/{r.get('spill_stores')}/{r.get('spill_loads')}"
                     if r else "not measured")
    res = {t_: kernel_resources(log, k) for t_, k in (("register", "qp_inner_reg_kernel"),
                                                      ("shared", "qp_inner_kernel"))}
    phase("K3-speed", card=repr(card), shape=f"B={B_NL},n={N_NL},m={M_NL},cold",
          tier=tier(N_NL, M_NL), ms_float32=f"{times[f32]:.4f}",
          ms_float64=f"{times[f64]:.4f}", plain_ms_float32=f"{plain:.4f}",
          ms_with_host_side_float32=f"{whole:.4f}", ms_before=K3_MS_BEFORE,
          bound_ms=f"{bound:.5f}", bound_by=by, refactorizations_twin=refact,
          refactorizations_per_lane=f"{refact / B_NL:.3f}",
          iters_mean_float32=f"{iters.mean():.1f}", iters_float32=hist25(iters),
          iters_mean_float64=f"{iters64.mean():.1f}", iters_float64=hist25(iters64),
          us_per_iteration_alone=f"{lat[1]:.3f}",
          **{f"us_per_iteration_B{n_sm}": f"{lat[n_sm]:.3f}"},
          **{f"regs_spill_st_ld_{t_}_{d}": fmt(r.get(d))
             for t_, r in res.items() for d in ("float32", "float64")},
          shared_shape=f"B={B_NL},n={n_s},m={m_s},cold,float32", shared_tier=tier(n_s, m_s),
          shared_ms_float32=f"{sh_ms:.4f}", shared_iters_mean=f"{sh_iters:.1f}",
          smem_bytes_per_instance=f"{qpf.smem_bytes(N_NL, M_NL, f32)}/"
                                  f"{qpf.smem_bytes(N_NL, M_NL, f64)}")
    return dict(ms=times[f32], plain_ms=plain, bound_ms=bound, bound_by=by, library_ms=None,
                ms_float64=times[f64], tier=tier(N_NL, M_NL), refactorizations_twin=refact)


def variant_library(name, text, tag):
    """Build ``text``, a modified copy of ``csrc/<name>``, as a source file
    of another name (``<stem>_<tag>.cu``: its anonymous namespace is its own)
    into a shared library of its own beside the kernel library, linked with
    ``-Bsymbolic`` so that every call it makes, the CUDA runtime's included,
    binds inside it and never to the kernel library loaded in the same
    process; returns it loaded (``ctypes.CDLL``)."""
    import ctypes
    b = _build_mod()
    out = b.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    for h in b.HEADERS:
        (out / h).write_text((b.CSRC / h).read_text())
    src = out / f"{name[:-3]}_{tag}.cu"
    src.write_text(text)
    lib_path = src.with_suffix(".so")
    subprocess.run([b.find_nvcc(), *b.NVCC_FLAGS, "-shared", "-Xlinker", "-Bsymbolic",
                    "-o", str(lib_path), str(src)], check=True, capture_output=True)
    return ctypes.CDLL(str(lib_path))


def clocked_library(name, text, entry, rows, width):
    """Build ``text``, an instrumented copy of ``csrc/<name>`` that adds
    cycles into ``__device__ unsigned long long clocks[rows * width]``, with
    :func:`variant_library`, its entry point ``entry`` renamed
    ``clocked_<entry>``.  Returns the entry point (with the kernel
    library's argument types) and ``read()``, which returns the counters as
    a (rows, width) array and zeroes them."""
    import ctypes
    b = _build_mod()
    require(entry in text, f"{name} defines {entry}")
    lib = variant_library(name, f"__device__ unsigned long long clocks[{rows * width}];\n"
                          + text.replace(entry, f"clocked_{entry}")
                          + '\nextern "C" int clocks_read(unsigned long long* out) {\n'
                            "  cudaError_t e = cudaMemcpyFromSymbol(out, clocks, sizeof(clocks));\n"
                            f"  static unsigned long long zero[{rows * width}];\n"
                            "  if (e == cudaSuccess) e = cudaMemcpyToSymbol(clocks, zero, "
                            "sizeof(zero));\n"
                            "  return (int)e;\n}\n", "clocked")
    fn = getattr(lib, f"clocked_{entry}")
    fn.argtypes = b._SIGNATURES[entry]
    fn.restype = ctypes.c_int
    lib.clocks_read.argtypes = [ctypes.c_void_p]
    buf = np.zeros(rows * width, dtype=np.uint64)

    def read():
        require(lib.clocks_read(buf.ctypes.data) == 0, f"{name}: counters read")
        return buf.reshape(rows, width).astype(np.float64)

    return fn, read


def print_clocks(tag, B, ms, cyc, sites, iters=None):
    """One line for the mean cycles of an instance (``cyc``: instances x
    sites, per call) and one per site: the cycles of the phase that ends
    there, its share and (``iters``: mean iterations) per iteration.  Fails
    unless every site counted cycles: each runs at least once an instance,
    so a zero means the instrumented copy did not run."""
    total = cyc.sum(axis=1).mean()
    per_it = {} if iters is None else dict(iters_mean=f"{iters:.1f}",
                                           cycles_per_iteration=f"{total / iters:.0f}")
    phase(tag, B=B, ms=f"{ms:.4f}", cycles_per_instance=f"{total:.0f}", **per_it)
    for sid, where in sites.items():
        c = cyc[:, sid].mean()
        phase(f"{tag}-site", B=B, site=sid, at=repr(where), cycles=f"{c:.0f}",
              per_iteration="-" if iters is None else f"{c / iters:.1f}",
              share=f"{c / total:.3f}" if total > 0 else "-")
    require(total > 0 and all(cyc[:, sid].mean() > 0 for sid in sites),
            f"{tag}: every site of the instrumented copy counted cycles at B={B}")


def phase_k4_clocks(torch):
    """``--k4-clocks``: where one K4 block's time goes.  A copy of
    ``csrc/traj_factor.cu`` in which thread 0 of every block reads
    ``clock64()`` after each barrier and adds the cycles since the last one
    to that barrier's counter (``clocked_library``) runs at the
    oscillators' shape, float32, 128 threads, with the full batch and with
    one instance per SM.  Each line is one barrier (its line in
    ``traj_factor.cu``; ``chol`` is a whole call of the Cholesky routine):
    the cycles of the phase that ends there, summed over the stages, mean
    over blocks, and its share.  Diagnostic only: the main path runs the
    kernel without counters."""
    import re
    b = _build_mod()
    src = (b.CSRC / "traj_factor.cu").read_text()
    k0, k1 = src.index("traj_factor_kernel(const T*"), src.index("template <typename T>\nint launch")
    body, sites = src[k0:k1], {}
    first_line = src[:k0].count("\n") + 1

    def mark(m):
        sid = len(sites)
        line = first_line + body[:m.start()].count("\n")
        sites[sid] = f"line {line}" + (" (chol)" if "block_chol" in m.group(0) else "")
        return f"{m.group(0)} K4_CLOCK({sid});"

    body = re.sub(r"__syncthreads\(\);|libmpc::block_chol_lower_inverse\([^;]*\);", mark, body)
    body = body.replace("T* sm = reinterpret_cast<T*>(smem_raw);",
                        "T* sm = reinterpret_cast<T*>(smem_raw);\n  unsigned long long t_last = clock64();")
    head = ("#define K4_CLOCK(id) do { if (threadIdx.x == 0) { unsigned long long t_ = "
            "clock64(); clocks[blockIdx.x * 64 + (id)] += t_ - t_last; t_last = t_; } "
            "} while (0)\n")
    fn, read = clocked_library("traj_factor.cu", head + src[:k0] + body + src[k1:],
                               "libmpc_traj_factor_f32", 4096, 64)
    data = [torch.as_tensor(a, dtype=torch.float32, device="cuda")
            for a in traj_blocks(B_OSC, PH_O, BSP_O, NX_O, W_O, seed=B_OSC)]
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for B in (B_OSC, n_sm):
        D, L, C, G = (a[:B].contiguous() for a in data)
        S, X, Gh = torch.empty_like(D), torch.empty_like(C), torch.empty_like(G)

        def call():
            code = fn(D.data_ptr(), L.data_ptr(), C.data_ptr(), G.data_ptr(), S.data_ptr(),
                      X.data_ptr(), Gh.data_ptr(), B, PH_O, BS_O, BSP_O, W_O, 128,
                      torch.cuda.current_stream().cuda_stream)
            require(code == 0, f"instrumented K4 launched ({code})")

        call()
        torch.cuda.synchronize()
        read()
        reps = 10
        ms = cuda_ms(torch, call, reps=reps, warmup=0)
        print_clocks("k4-clocks", B, ms, read()[:B] / reps, sites)


def phase_k3_clocks(torch, qpf):
    """``--k3-clocks``: where one K3 instance's time goes on the register
    tier.  ``csrc/qp_inner.cu`` marks the end of each phase of the register
    tier's kernel with ``K3_CLOCK(site);  // what the phase does`` (nothing
    in the kernel library);
    the copy built here (``clocked_library``) defines it so that every lane
    reads ``clock()`` there and adds the cycles since the last site to that
    site's counter (registers, no branch; lane 0 writes them out at the
    end).  It runs at the path's shape, float32, cold, on the full batch,
    with one instance per SM and with one instance alone.  Each line is one
    site (its line in ``qp_inner.cu`` and its comment): the cycles
    of the phase that ends there, summed over the solve, mean over
    instances, per iteration, and its share.  Diagnostic only: the main path
    runs the kernel without counters."""
    import re
    src = (_build_mod().CSRC / "qp_inner.cu").read_text()
    lines, sites = src.splitlines(), {}
    for i, text in enumerate(lines):
        m = re.search(r"\bK3_CLOCK\((\d+)\);\s*//\s*(.*)", text)
        if m:
            sites[int(m.group(1))] = f"line {i + 1}: {m.group(2).strip()}"
    n_sites = len(sites)
    require(sorted(sites) == list(range(n_sites)) and n_sites <= 16,
            "qp_inner.cu numbers its K3_CLOCK sites 0, 1, ... (at most 16)")
    head = ("#define K3_CLOCK_START unsigned k3c_[16] = {}; unsigned k3t_ = (unsigned)clock();\n"
            "#define K3_CLOCK(site) do { const unsigned t_ = (unsigned)clock(); "
            "k3c_[site] += t_ - k3t_; k3t_ = t_; } while (0)\n"
            "#define K3_CLOCK_FLUSH(inst) if (lane == 0) { _Pragma(\"unroll\") "
            "for (int i_ = 0; i_ < 16; ++i_) clocks[(inst) * 16 + i_] += k3c_[i_]; }\n")
    fn, read = clocked_library("qp_inner.cu", head + src, "libmpc_qp_inner_f32", 4096, 16)
    f32 = torch.float32
    args = k3_scaled_args(torch, qpf, vdp_qps(B_NL, 0), f32)
    kw = dict(K3_KW, refine=True)
    n_blocks = (kw["max_iter"] + kw["check_every"] - 1) // kw["check_every"]
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for B in (B_NL, n_sm, 1):
        sub = [a[:B].contiguous() for a in args]
        n, m = N_NL, M_NL
        outs = [torch.empty((B, n), dtype=f32, device="cuda"),
                torch.empty((B, m), dtype=f32, device="cuda"),
                torch.empty((B, m), dtype=f32, device="cuda"),
                torch.empty((B,), dtype=torch.int32, device="cuda"),
                torch.empty((B,), dtype=torch.int32, device="cuda"),
                torch.empty((B,), dtype=f32, device="cuda"),
                torch.empty((B,), dtype=f32, device="cuda")]

        def call():
            code = fn(*(a.data_ptr() for a in sub), *(o.data_ptr() for o in outs), B, n, m,
                      kw["sigma"], kw["alpha"], kw["eps_abs"], kw["eps_rel"], n_blocks,
                      kw["check_every"], 1, 1, torch.cuda.current_stream().cuda_stream)
            require(code == 0, f"instrumented K3 launched ({code})")

        call()
        torch.cuda.synchronize()
        read()
        reps = 5
        ms = cuda_ms(torch, call, reps=reps, warmup=0)
        iters = outs[3].double().mean().item()
        print_clocks("k3-clocks", B, ms, read()[:B, :n_sites] / reps, sites, iters)


def phase_k1_clocks(torch, admm_fused):
    """``--k1-clocks``: where a staged K1 block's time goes.  ``csrc/
    admm_fused.cu`` marks the end of each phase with ``K1_CLOCK(site);  //
    what the phase does`` (nothing in the kernel library); the copy built
    here (``clocked_library``) defines it so that thread 0 of each block
    reads ``clock()`` there and adds the cycles since the last site to that
    site's counter.  Float32 with refinement at the quadrotor shape, 10
    iterations, the staged tier at the tile its cost model picks for
    B=16384, with the full batch and with one tile alone.
    Diagnostic only: the main path runs the kernel without counters."""
    import re
    src = (_build_mod().CSRC / "admm_fused.cu").read_text()
    lines, sites = src.splitlines(), {}
    for i, text in enumerate(lines):
        m = re.search(r"\bK1_CLOCK\((\d+)\);\s*//\s*(.*)", text)
        if m:
            sites[int(m.group(1))] = f"line {i + 1}: {m.group(2).strip()}"
    n_sites = len(sites)
    require(sorted(sites) == list(range(n_sites)) and n_sites <= 16,
            "admm_fused.cu numbers its K1_CLOCK sites 0, 1, ... (at most 16)")
    rows = 4096
    head = ("#define K1_CLOCK_START unsigned k1c_[16] = {}; unsigned k1t_ = (unsigned)clock();\n"
            "#define K1_CLOCK(site) do { const unsigned t_ = (unsigned)clock(); "
            "k1c_[site] += t_ - k1t_; k1t_ = t_; } while (0)\n"
            "#define K1_CLOCK_FLUSH() if (threadIdx.x == 0 && blockIdx.x < "
            f"{rows}) {{ _Pragma(\"unroll\") "
            "for (int i_ = 0; i_ < 16; ++i_) clocks[blockIdx.x * 16 + i_] += k1c_[i_]; }\n")
    fn, read = clocked_library("admm_fused.cu", head + src, "libmpc_admm_fused_f32", rows, 16)
    f32 = torch.float32
    data = k1_problem(B_MAIN, N_QP, M_QP)
    t = {k: torch.as_tensor(v, dtype=f32, device="cuda") for k, v in data.items()
         if k != "sigma"}
    bt = admm_fused.staged_layout(B_MAIN, N_QP, M_QP).bt
    for B in (B_MAIN, bt):
        lay = admm_fused.staged_layout(B, N_QP, M_QP, bt)
        ins = [torch.zeros((B, N_QP), device="cuda"), torch.zeros((B, M_QP), device="cuda"),
               torch.zeros((B, M_QP), device="cuda"),
               torch.zeros(B, dtype=torch.bool, device="cuda"),
               t["q"][:B].contiguous(), t["l"][:B].contiguous(), t["u"][:B].contiguous()]
        outs = [torch.empty_like(ins[0]), torch.empty_like(ins[1]), torch.empty_like(ins[2])]

        def call():
            code = fn(*(a.data_ptr() for a in ins), t["A"].data_ptr(), None,
                      t["M"].data_ptr(), t["Minv"].data_ptr(), t["rho"].data_ptr(),
                      *(o.data_ptr() for o in outs), B, N_QP, M_QP, 10, data["sigma"], 1.6,
                      1, lay.tier, lay.bt, lay.stages,
                      torch.cuda.current_stream().cuda_stream)
            require(code == 0, f"instrumented K1 launched ({code})")

        call()
        torch.cuda.synchronize()
        read()
        reps = 5
        ms = cuda_ms(torch, call, reps=reps, warmup=0)
        cyc = read()[:min(lay.grid, rows), :n_sites] / reps
        print_clocks(f"k1-clocks-bt{lay.bt}", B, ms, cyc, sites, 10.0)


# -- the networked oscillators of examples/networked_oscillators_ex.cpp --------
def osc_dynamics(x, u, k):
    """Six diffusively coupled Van der Pol oscillators (bench.py:565-578):
    12 states, 6 inputs.  No in-place writes, so ``torch.func`` can
    differentiate it."""
    import torch
    pos, vel = x[0::2], x[1::2]
    coupling = 0.1 * (torch.sum(pos) - 6 * pos)
    dvel = (1.0 - pos**2) * vel - pos + u + coupling
    return torch.stack([vel, dvel], dim=1).reshape(-1)


def osc_params(lt, **over):
    """The shipped two-phase settings (bench.py:598-602): a flat cap of 30
    interior-point iterations, then the compacted rescue at 45."""
    kw = dict(maximum_iteration=30, enable_warm_start=True, hessian_reg="gauss_newton",
              inner_qp="fused", inner_iters=30, inner_iters_recovery=30, rescue_iters=45)
    kw.update(over)
    return lt.NLParameters(**kw)


def osc_controller(lt, dtype, device, params):
    import torch
    c = lt.NLMPC(NX_O, NU_O, NX_O, PH_O, CH_O, MI_O, 0, dtype=dtype, device=device)
    c.set_discretization_sampling_time(0.1)
    c.set_state_space_function(osc_dynamics)
    c.set_objective_function(lambda X, Y, U, e: torch.sum(X**2) + torch.sum(U**2))
    c.set_ineq_con_function(lambda X, Y, U, e: (U - 0.5).reshape(-1))
    c.set_optimizer_parameters(params)
    return c


def osc_inputs(B, K):
    """bench.py:610-612."""
    rng = np.random.default_rng(13)
    x0 = rng.uniform(-0.5, 0.5, size=(B, NX_O))
    noise = 0.01 * rng.normal(size=(K, B, NX_O))
    return x0, noise


def osc_plant(torch, noise):
    """bench.py:615-617: x + 0.1 f(x, u) + noise[k]."""
    f = torch.func.vmap(osc_dynamics, in_dims=(0, 0, None))
    return lambda x, u, k: x + 0.1 * f(x, u, k) + noise[k]


def traj_blocks(B, ph, bs_p, nx, w, seed, terms=None):
    """Stage blocks (D, L, C, G) of a batch of quasi-definite bordered
    block-tridiagonal matrices, float64: the construction of
    tests/test_trajectory_kkt.py:43-81 (a primal Gram of rank-one terms per
    stage over [stage k; stage k+1; border] plus 0.1 I, a dual diagonal of
    -0.05, random coupling of each stage's dual rows to its own and the
    previous stage's primal slots and to the border), built block by block for
    the whole batch.  ``terms`` is the number of rank-one terms per stage:
    that test's six give its 5-wide primal blocks full rank but leave an
    18-wide one resting on the 0.1 I (ill-conditioned: float32 evaluations of
    the factorization then part at 1e-3); the default, 2 bs_p, gives full rank
    at any width."""
    rng = np.random.default_rng(seed)
    bs = bs_p + nx
    nt = max(6, 2 * bs_p) if terms is None else terms
    a = rng.normal(size=(B, ph, nt, bs_p))  # on the stage's own primal slots
    b = rng.normal(size=(B, ph, nt, bs_p))  # on the next stage's
    c = rng.normal(size=(B, ph, nt, w))  # on the border
    b[:, ph - 1] = 0.0  # the last stage has no successor
    gram = lambda u, v: np.einsum("bkri,bkrj->bkij", u, v)
    D = np.zeros((B, ph, bs, bs))
    L = np.zeros((B, ph - 1, bs, bs))
    C = np.zeros((B, ph, bs, w))
    D[:, :, :bs_p, :bs_p] = gram(a, a) + 0.1 * np.eye(bs_p)
    D[:, 1:, :bs_p, :bs_p] += gram(b[:, :-1], b[:, :-1])
    L[:, :, :bs_p, :bs_p] = gram(b[:, :-1], a[:, :-1])
    C[:, :, :bs_p] = gram(a, c)
    C[:, 1:, :bs_p] += gram(b[:, :-1], c[:, :-1])
    G = np.einsum("bkri,bkrj->bij", c, c) + 0.1 * np.eye(w)
    D[:, :, bs_p:, bs_p:] = -0.05 * np.eye(nx)
    X = rng.normal(size=(B, ph, nx, bs_p))
    D[:, :, bs_p:, :bs_p] = X
    D[:, :, :bs_p, bs_p:] = np.swapaxes(X, 2, 3)
    C[:, :, bs_p:] = rng.normal(size=(B, ph, nx, w))
    L[:, :, bs_p:, :bs_p] = rng.normal(size=(B, ph - 1, nx, bs_p))
    return D, L, C, G


def dense_from_blocks(D, L, C, G):
    """The assembled matrix of one instance."""
    ph, bs, _ = D.shape
    w = G.shape[0]
    n = ph * bs + w
    M = np.zeros((n, n))
    for k in range(ph):
        r = slice(k * bs, (k + 1) * bs)
        M[r, r] = D[k]
        M[r, ph * bs:] = C[k]
        M[ph * bs:, r] = C[k].T
        if k:
            q = slice((k - 1) * bs, k * bs)
            M[r, q] = L[k - 1]
            M[q, r] = L[k - 1].T
    M[ph * bs:, ph * bs:] = G
    return M


def _rel(got, want):
    return ((got - want).abs().max() / want.abs().max().clamp(min=1e-30)).item()


def _sym(M):
    return 0.5 * (M + M.transpose(-1, -2))


# (B, ph, bs_p, nx, w): the oscillators' shape, a ragged batch of it, a
# single-stage problem (no sub-diagonal block), and the edges of K4's tiles:
# a stage block just past 32 (bs = 33), one primal and one dual slot (bs = 2;
# with more dual slots these blocks part at 1e-4 in float32 whoever evaluates
# them), a border wider than
# the block, the Van der Pol float64 shape (bench.py:444-480 through the banded
# engine), and the largest float64 shape K4's gate admits at the oscillators'
# proportions (bs_p = bs - bs // 3, w = 8; bs = 73 is refused)
K4_LARGEST_F64 = (64, 4, 48, 24, 8)
TRAJ_CASES = ((B_OSC, PH_O, BSP_O, NX_O, W_O), (1003, PH_O, BSP_O, NX_O, W_O),
              (37, 1, 3, 2, 3), (256, 20, 20, 13, 9), (256, 8, 1, 1, 3),
              (256, 6, 5, 3, 12), (1024, 10, 3, 2, 3), K4_LARGEST_F64)
K4_MS_BEFORE = 2.327  # K4 float32 at the oscillators' shape before its redesign (PERF.md)
K4_SLACK = 3.0  # float32 K4 against float64, as a multiple of its twin's distance
K5_MS_BEFORE = 0.551  # K5 float32 at the oscillators' shape before its redesign (PERF.md)


def osc_kkt_blocks(torch, lt, tk, lanes=64, keep=(0, 4, 9, 19)):
    """Stage blocks (D, L, C, G) as the oscillator path hands them to K4:
    one cold ``optimize`` step of ``lanes`` lanes, float32, the shipped
    settings, with ``trajectory_kkt.traj_factor`` wrapped for its duration so
    that the inputs of factorizations number ``keep`` (interior-point
    iterations of the first inner solve) and of the step's last one are
    copied.  Returns [(number, [D, L, C, G]), ...]."""
    x0_h, _ = osc_inputs(lanes, 1)
    c = osc_controller(lt, torch.float32, "cuda", osc_params(lt))
    kept, last, inner = [], [], tk.traj_factor

    def spy(plan, D, L, C, G):
        n = spy.calls
        spy.calls += 1
        if n in keep:
            kept.append((n, [a.clone() for a in (D, L, C, G)]))
        last[:] = [(n, [a.clone() for a in (D, L, C, G)])]
        return inner(plan, D, L, C, G)

    spy.calls = 0
    tk.traj_factor = spy
    try:
        c.optimize(torch.as_tensor(x0_h, dtype=torch.float32, device="cuda"),
                   torch.zeros((lanes, NU_O), dtype=torch.float32, device="cuda"))
    finally:
        tk.traj_factor = inner
    return kept + [b for b in last if b[0] not in keep]


def k4_float32_against_float64(torch, ts, t32, bs_p):
    """The float32 kernel and the float32 twin on the same float32 blocks,
    each against the float64 twin of those blocks: errors relative to scale
    on Sinv, X and the symmetrized border Schur complement, per lane.
    Returns (kernel errors (3, B), twin errors (3, B), kernel against twin (3,))."""
    ref = ts.traj_factor_plain(*(a.double() for a in t32), bs_p)
    got = ts.batched_factor(*t32, bs_p)
    twin = ts.traj_factor_plain(*t32, bs_p)
    torch.cuda.synchronize()
    require(all(bool(torch.isfinite(o).all().item()) for o in got), "K4 output finite")
    ref = (ref[0], ref[1], _sym(ref[2]))

    def lanes(out):
        out = (out[0], out[1], _sym(out[2]))
        return torch.stack([
            (o.double() - r).flatten(1).abs().amax(dim=1) / r.abs().max().clamp(min=1e-30)
            for o, r in zip(out, ref)]).cpu().numpy()

    pair = [_rel(got[0], twin[0]), _rel(got[1], twin[1]), _rel(_sym(got[2]), _sym(twin[2]))]
    return lanes(got), lanes(twin), pair


def phase_k4(torch, ts, lt, tk):
    """K4 against its twin on the card.

    On well-conditioned blocks (``traj_blocks`` with full-rank primal Grams):
    float64 within 1e-10 of scale on Sinv, X and the symmetrized border Schur
    complement, float32 within 1e-4.

    On ill-conditioned blocks two float32 evaluations of the same
    factorization part by their rounding, so there the float32 kernel and the
    float32 twin are each held against the float64 twin of the same float32
    blocks, and the kernel may be no further from it than ``K4_SLACK`` times
    the twin is (largest lane and median lane): on the six-term construction
    of tests/test_trajectory_kkt.py at the oscillators' width, and on the
    blocks of real interior-point iterations of the oscillator path (early
    ones and the step's last, where the barrier weights are largest).
    float64 kernel against float64 twin stays at 1e-10 on all of them."""
    res = {}
    for B, ph, bs_p, nx, w in TRAJ_CASES:
        data = traj_blocks(B, ph, bs_p, nx, w, seed=B)
        for dtype, tol in ((torch.float64, 1e-10), (torch.float32, 1e-4)):
            t = [torch.as_tensor(a, dtype=dtype, device="cuda") for a in data]
            got = ts.batched_factor(*t, bs_p)
            torch.cuda.synchronize()
            want = ts.traj_factor_plain(*t, bs_p)
            torch.cuda.synchronize()
            require(all(bool(torch.isfinite(o).all().item()) for o in got), "K4 output finite")
            rel = [_rel(got[0], want[0]), _rel(got[1], want[1]),
                   _rel(_sym(got[2]), _sym(want[2]))]
            absmax = max((g - w_).abs().max().item() for g, w_ in zip(got, want))
            name = str(dtype).split(".")[-1]
            phase("K4", dtype=name, B=B, ph=ph, bs=bs_p + nx, bs_p=bs_p, w=w,
                  rel_err_Sinv_X_Ghat="/".join(f"{r:.2e}" for r in rel), tol=tol,
                  max_abs_err=f"{absmax:.3e}",
                  smem_bytes=ts.factor_smem_bytes(bs_p + nx, bs_p, w, dtype))
            require(max(rel) <= tol, f"K4 {name} B={B} ph={ph} within {tol} of its twin")
            if (B, ph, bs_p, nx, w) == TRAJ_CASES[0] and dtype == torch.float32:
                res["float32"] = absmax

    hard = [("six-term", [torch.as_tensor(a, dtype=torch.float32, device="cuda") for a in
                          traj_blocks(B_OSC, PH_O, BSP_O, NX_O, W_O, seed=7, terms=6)])]
    hard += [(f"osc-ipm-{n}", blocks) for n, blocks in osc_kkt_blocks(torch, lt, tk)]
    for tag, t32 in hard:
        t64 = [a.double() for a in t32]
        got, want = ts.batched_factor(*t64, BSP_O), ts.traj_factor_plain(*t64, BSP_O)
        rel64 = max(_rel(got[0], want[0]), _rel(got[1], want[1]),
                    _rel(_sym(got[2]), _sym(want[2])))
        ek, et, pair = k4_float32_against_float64(torch, ts, t32, BSP_O)
        worst_k, worst_t = float(ek.max()), float(et.max())
        med_k, med_t = float(np.median(ek.max(axis=0))), float(np.median(et.max(axis=0)))
        phase("K4-hard", data=tag, B=t32[0].shape[0], float64_kernel_vs_twin=f"{rel64:.2e}",
              tol64=1e-10, float32_kernel_vs_float64="/".join(f"{e:.2e}" for e in ek.max(axis=1)),
              float32_twin_vs_float64="/".join(f"{e:.2e}" for e in et.max(axis=1)),
              float32_kernel_vs_twin="/".join(f"{e:.2e}" for e in pair),
              lane_median_kernel=f"{med_k:.2e}", lane_median_twin=f"{med_t:.2e}",
              slack=K4_SLACK)
        require(rel64 <= 1e-10, f"K4 float64 within 1e-10 of its twin on {tag}")
        require(worst_k <= K4_SLACK * worst_t and med_k <= K4_SLACK * med_t,
                f"K4 float32 no further from float64 than {K4_SLACK} x its twin on {tag}")
    return res


def kernel_resources(log, name, by_tile=False):
    """Registers and spill bytes of each float/double instance of kernel
    ``name``, from the ``-Xptxas -v`` lines of the build; with ``by_tile``,
    of each (type, first integer template argument) instance, keyed
    ``float32_24`` and so on."""
    import re
    out, cur = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            # a kernel templated on its tile alone is a float32 one
            t = re.search(rf"{name}I([fd])?(?:Li(\d+)E)?", ln)
            cur = None
            if t:
                cur = "float64" if t[1] == "d" else "float32"
                if by_tile and t[2]:
                    cur += f"_{t[2]}"
        elif cur and "spill stores" in ln:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
            out.setdefault(cur, {}).update(spill_stores=int(m[1]), spill_loads=int(m[2]))
        elif cur and "Used" in ln and "registers" in ln:
            out.setdefault(cur, {})["registers"] = int(re.search(r"Used (\d+) registers", ln)[1])
    return out


def phase_k4_speed(torch, ts, card):
    """K4's time at the oscillators' shape (CUDA events), float32 and
    float64, beside the float32 plain twin's time, its bound, its time
    before the redesign and its registers and spills; float32 also at 64,
    128 and 256 threads a block and with one instance per SM.  Returns the
    kernels line's numbers."""
    blocks = traj_blocks(B_OSC, PH_O, BSP_O, NX_O, W_O, seed=B_OSC)
    data = {dt: [torch.as_tensor(a, dtype=dt, device="cuda") for a in blocks]
            for dt in (torch.float32, torch.float64)}
    times = {dt: cuda_ms(torch, lambda: ts.batched_factor(*t, BSP_O), reps=20)
             for dt, t in data.items()}
    plain = cuda_ms(torch, lambda: ts.traj_factor_plain(*data[torch.float32], BSP_O), reps=3,
                    warmup=1)
    # float32 at other block sizes, and with one instance per SM (the chain of
    # one instance alone: latency, where the full batch adds contention)
    threads, by_threads = ts.FACTOR_THREADS, {}
    try:
        for nt in (64, 128, 256):
            ts.FACTOR_THREADS = nt
            by_threads[nt] = cuda_ms(
                torch, lambda: ts.batched_factor(*data[torch.float32], BSP_O), reps=20)
    finally:
        ts.FACTOR_THREADS = threads
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    one = [a[:n_sm].contiguous() for a in data[torch.float32]]
    t_one = cuda_ms(torch, lambda: ts.batched_factor(*one, BSP_O), reps=20)
    bound, by = traj_factor_bound_ms(B_OSC, PH_O, BS_O, BSP_O, W_O)
    res = kernel_resources(_build_mod().build_info.get("log", ""), "traj_factor_kernel")
    fmt = lambda r: (f"{r.get('registers')}/{r.get('spill_stores')}/{r.get('spill_loads')}"
                     if r else "not measured")
    phase("K4-speed", card=repr(card),
          shape=f"B={B_OSC},ph={PH_O},bs={BS_O},bs_p={BSP_O},w={W_O}",
          ms_float32=f"{times[torch.float32]:.4f}", ms_float64=f"{times[torch.float64]:.4f}",
          plain_ms_float32=f"{plain:.4f}", ms_before=K4_MS_BEFORE, bound_ms=f"{bound:.5f}",
          bound_by=by, threads=threads,
          ms_float32_by_threads="/".join(f"{k}:{v:.4f}" for k, v in by_threads.items()),
          **{f"ms_float32_B{n_sm}_one_per_sm": f"{t_one:.4f}"},
          regs_spill_st_ld_float32=fmt(res.get("float32")),
          regs_spill_st_ld_float64=fmt(res.get("float64")),
          smem_bytes_float32=ts.factor_smem_bytes(BS_O, BSP_O, W_O, torch.float32),
          smem_bytes_float64=ts.factor_smem_bytes(BS_O, BSP_O, W_O, torch.float64))
    return dict(ms=times[torch.float32], plain_ms=plain, bound_ms=bound, bound_by=by,
                library_ms=None)


def phase_k5(torch, ts, batched_linalg):
    """K5 against its twin on the card, on the factors the twin of K4 makes of
    the same data, at every ``TRAJ_CASES`` shape: float64 within 1e-10 of
    scale on xs and g; float32 within 1e-5 of (scale + 1), the tolerance of
    tests/test_trajectory_kkt.py:133-135.  Then K4, K2 and K5 together
    against ``numpy.linalg.solve`` of the assembled matrix on three lanes,
    float64, 1e-9; then K5 on unaligned inputs."""
    res = {}
    for B, ph, bs_p, nx, w in TRAJ_CASES:
        bs = bs_p + nx
        require(ts.sweeps_supported(ph, bs, w, torch.float64),
                f"K5's gate admits B={B} ph={ph} bs={bs} w={w} in float64")
        data = traj_blocks(B, ph, bs_p, nx, w, seed=B)
        rng = np.random.default_rng(B + 1)
        r_h = rng.normal(size=(B, ph * bs + w))
        t64 = [torch.as_tensor(a, device="cuda") for a in data]
        Sinv, X, Ghat = ts.traj_factor_plain(*t64, bs_p)
        Gi = torch.linalg.inv(_sym(Ghat))
        rs = torch.as_tensor(r_h[:, :ph * bs].reshape(B, ph, bs), device="cuda").contiguous()
        rg = torch.as_tensor(r_h[:, ph * bs:], device="cuda").contiguous()
        for dtype, tol in ((torch.float64, 1e-10), (torch.float32, 1e-5)):
            args = [a.to(dtype).contiguous() for a in (Sinv, t64[1], X, Gi, rs, rg)]
            got = ts.batched_sweep_solve(*args)
            torch.cuda.synchronize()
            want = ts.traj_solve_plain(*args)
            torch.cuda.synchronize()
            require(all(bool(torch.isfinite(o).all().item()) for o in got), "K5 output finite")
            scale = want[0].abs().max().item() + (1.0 if dtype == torch.float32 else 0.0)
            err = [(g - w_).abs().max().item() / scale for g, w_ in zip(got, want)]
            absmax = max((g - w_).abs().max().item() for g, w_ in zip(got, want))
            name = str(dtype).split(".")[-1]
            phase("K5", dtype=name, B=B, ph=ph, bs=bs, w=w,
                  err_xs_g_over_scale="/".join(f"{e:.2e}" for e in err), tol=tol,
                  scale=f"{scale:.3e}", max_abs_err=f"{absmax:.3e}",
                  smem_bytes=ts.sweep_smem_bytes(ph, bs, w, dtype))
            require(max(err) <= tol, f"K5 {name} B={B} ph={ph} within {tol} of its twin")
            if (B, ph, bs_p, nx, w) == TRAJ_CASES[0] and dtype == torch.float32:
                res["float32"] = absmax
        # the three kernels together against a dense solve
        Sk, Xk, Gk = ts.batched_factor(*t64, bs_p)
        Gik = batched_linalg.chol_inverse(_sym(Gk).contiguous())
        xs, xg = ts.batched_sweep_solve(Sk, t64[1], Xk, Gik, rs, rg)
        torch.cuda.synchronize()
        worst = 0.0
        for lane in (0, B // 2, B - 1):
            ref = np.linalg.solve(dense_from_blocks(*(a[lane] for a in data)), r_h[lane])
            x = np.concatenate([xs[lane].cpu().numpy().ravel(), xg[lane].cpu().numpy()])
            worst = max(worst, float(np.abs(x - ref).max() / np.abs(ref).max()))
        phase("K4+K2+K5-dense", dtype="float64", B=B, ph=ph, lanes=3,
              rel_err=f"{worst:.3e}", tol=1e-9)
        require(worst <= 1e-9, f"factor and solve within 1e-9 of a dense solve (B={B}, ph={ph})")
    phase_k5_unaligned(torch, ts)
    return res


def unaligned_copy(torch, t, offset=1):
    """A contiguous copy of ``t`` whose storage starts ``offset`` elements
    into a larger buffer, so that its base pointer is not 16-byte aligned."""
    flat = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    out = flat[offset:].view(t.shape)
    out.copy_(t)
    return out


def phase_k5_unaligned(torch, ts):
    """K5 on inputs whose base pointers sit one element past a 16-byte
    boundary (the copies then move 4- or 8-byte chunks), at the oscillators'
    shape and at bs = 33, against the twin with ``phase_k5``'s tolerances."""
    for B, ph, bs_p, nx, w in (TRAJ_CASES[0], (256, 20, 20, 13, 9)):
        bs = bs_p + nx
        t64 = [torch.as_tensor(a, device="cuda")
               for a in traj_blocks(B, ph, bs_p, nx, w, seed=B + 2)]
        Sinv, X, Ghat = ts.traj_factor_plain(*t64, bs_p)
        Gi = torch.linalg.inv(_sym(Ghat))
        g = torch.Generator("cuda").manual_seed(B)
        rs = torch.randn((B, ph, bs), dtype=torch.float64, device="cuda", generator=g)
        rg = torch.randn((B, w), dtype=torch.float64, device="cuda", generator=g)
        for dtype, tol in ((torch.float64, 1e-10), (torch.float32, 1e-5)):
            args = [unaligned_copy(torch, a.to(dtype)) for a in (Sinv, t64[1], X, Gi, rs, rg)]
            require(all(a.data_ptr() % 16 != 0 and a.is_contiguous() for a in args),
                    "unaligned copies")
            got = ts.batched_sweep_solve(*args)
            want = ts.traj_solve_plain(*args)
            torch.cuda.synchronize()
            scale = want[0].abs().max().item() + (1.0 if dtype == torch.float32 else 0.0)
            err = [(g_ - w_).abs().max().item() / scale for g_, w_ in zip(got, want)]
            name = str(dtype).split(".")[-1]
            phase("K5-unaligned", dtype=name, B=B, ph=ph, bs=bs, w=w,
                  err_xs_g_over_scale="/".join(f"{e:.2e}" for e in err), tol=tol)
            require(max(err) <= tol, f"K5 {name} on unaligned inputs within {tol} of its twin")


def sweep_inputs(torch, ts, batched_linalg, data):
    """K5's arguments at the oscillators' shape from the blocks ``data`` (D,
    L, C, G): K4's factors, the border inverse through K2, a random
    right-hand side."""
    dtype = data[0].dtype
    Sinv, X, Ghat = ts.batched_factor(*data, BSP_O)
    Gi = batched_linalg.chol_inverse(_sym(Ghat).contiguous())
    g = torch.Generator("cuda").manual_seed(0)
    rs = torch.randn((B_OSC, PH_O, BS_O), dtype=dtype, device="cuda", generator=g)
    rg = torch.ones((B_OSC, W_O), dtype=dtype, device="cuda")
    return (Sinv, data[1], X, Gi, rs, rg)


def phase_k5_speed(torch, ts, batched_linalg, card):
    """K5's time at the oscillators' shape (CUDA events), float32 and
    float64, beside the float32 plain twin's time, its bound, its time
    before the redesign, its registers and spills and its shared memory;
    float32 also at each number of instances a block and with one instance
    per SM (B = the SM count: one instance's chain alone).  Returns the
    kernels line's numbers."""
    blocks = traj_blocks(B_OSC, PH_O, BSP_O, NX_O, W_O, seed=B_OSC)
    args = {dt: sweep_inputs(torch, ts, batched_linalg,
                             [torch.as_tensor(a, dtype=dt, device="cuda") for a in blocks])
            for dt in (torch.float32, torch.float64)}
    times = {dt: cuda_ms(torch, lambda: ts.batched_sweep_solve(*a), reps=50)
             for dt, a in args.items()}
    plain = cuda_ms(torch, lambda: ts.traj_solve_plain(*args[torch.float32]), reps=3, warmup=1)
    warps, by_warps = ts.SWEEP_WARPS, {}
    try:
        for nw in (1, 2, 4, 8):
            ts.SWEEP_WARPS = nw
            by_warps[nw] = cuda_ms(
                torch, lambda: ts.batched_sweep_solve(*args[torch.float32]), reps=50)
    finally:
        ts.SWEEP_WARPS = warps
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    one = [a[:n_sm].contiguous() for a in args[torch.float32]]
    t_one = cuda_ms(torch, lambda: ts.batched_sweep_solve(*one), reps=50)
    bound, by = traj_sweep_bound_ms(B_OSC, PH_O, BS_O, W_O)
    res = kernel_resources(_build_mod().build_info.get("log", ""), "traj_sweep_kernel")
    fmt = lambda r: (f"{r.get('registers')}/{r.get('spill_stores')}/{r.get('spill_loads')}"
                     if r else "not measured")
    smem = {dt: ts.sweep_smem_bytes(PH_O, BS_O, W_O, dt) for dt in args}
    phase("K5-speed", card=repr(card), shape=f"B={B_OSC},ph={PH_O},bs={BS_O},w={W_O}",
          ms_float32=f"{times[torch.float32]:.4f}", ms_float64=f"{times[torch.float64]:.4f}",
          plain_ms_float32=f"{plain:.4f}", ms_before=K5_MS_BEFORE, bound_ms=f"{bound:.5f}",
          bound_by=by, instances_per_block=warps,
          ms_float32_by_instances_per_block="/".join(f"{k}:{v:.4f}" for k, v in by_warps.items()),
          **{f"ms_float32_B{n_sm}_one_per_sm": f"{t_one:.4f}"},
          regs_spill_st_ld_float32=fmt(res.get("float32")),
          regs_spill_st_ld_float64=fmt(res.get("float64")),
          smem_bytes_per_instance_float32=smem[torch.float32],
          smem_bytes_per_instance_float64=smem[torch.float64],
          smem_bytes_per_block=f"{warps * smem[torch.float32]}/{warps * smem[torch.float64]}")
    return dict(ms=times[torch.float32], plain_ms=plain, bound_ms=bound, bound_by=by,
                library_ms=None)


K2_BLOCKED_SHAPES = ((256, NZ_O + 1), (256, ME_O))  # float32 pdip at oscillator size


def phase_k2_blocked(torch, batched_linalg):
    """K2's blocked recursion (48-wide diagonal blocks through the kernel,
    the rest as batched products) against ``chol_inverse_plain`` at the sizes
    the float32 dense interior point would give it for the oscillators."""
    res = {}
    for B, k in K2_BLOCKED_SHAPES:
        C64 = torch.as_tensor(spd_batch(B, k, seed=k), device="cuda")
        eye = torch.eye(k, dtype=torch.float64, device="cuda")
        for dtype, tol, rtol in ((torch.float32, 1e-4, 1e-3), (torch.float64, 1e-10, 1e-8)):
            C = C64.to(dtype)
            n0 = batched_linalg.chol_inverse.launches
            got = batched_linalg.spd_inverse(C)
            n_leaf = batched_linalg.chol_inverse.launches - n0
            want = batched_linalg.chol_inverse_plain(C)
            torch.cuda.synchronize()
            rel = _rel(got, want)
            resid = (C.double() @ got.double() - eye).abs().amax(dim=(1, 2)).max().item()
            name = str(dtype).split(".")[-1]
            phase("K2-blocked", dtype=name, shape=f"({B},{k},{k})", rel_err=f"{rel:.3e}",
                  tol=tol, resid_inf=f"{resid:.3e}", resid_tol=rtol, leaf_launches=n_leaf)
            require(rel <= tol, f"blocked K2 {name} ({B},{k},{k}) within {tol} of its twin")
            require(resid <= rtol, f"blocked K2 {name} ||C Cinv - I|| <= {rtol}")
            require(n_leaf > 1, "blocked K2 went through the kernel's leaves")
            if dtype == torch.float32 and k == NZ_O + 1:
                res["float32"] = (got - want).abs().max().item()
    return res


def phase_k2_every_k(torch, bl):
    """K2 against its twin at every k from 1 to 64 in both types, on a ragged
    batch of 37 (past a block's end in every layout): at :func:`layout`'s
    choice and, for k <= 32, with the block tier forced; ||C C^-1 - I|| too.
    Returns the largest float32 error."""
    worst = {}
    for dtype, tol, rtol in ((torch.float32, 1e-4, 1e-3), (torch.float64, 1e-10, 1e-8)):
        name = str(dtype).split(".")[-1]
        for k in range(1, bl.MAX_K + 1):
            C = torch.as_tensor(spd_batch(37, k, seed=k), dtype=dtype, device="cuda")
            eye = torch.eye(k, dtype=torch.float64, device="cuda")
            want = bl.chol_inverse_plain(C)
            lays = [bl.layout(37, k, dtype)]
            if k <= bl.REG_MAX_K:
                lays.append(bl.block_layout(37, k, dtype))
            for lay in lays:
                got = bl.launch(lay, C)
                torch.cuda.synchronize()
                rel = _rel(got, want)
                resid = (C.double() @ got.double() - eye).abs().amax(dim=(1, 2)).max().item()
                tier = "register" if lay.tier == bl.TIER_REGISTER else "block"
                require(rel <= tol, f"K2 {name} k={k} {tier} tier within {tol} of its twin")
                require(resid <= rtol, f"K2 {name} k={k} {tier} tier ||C Cinv - I|| <= {rtol}")
                w = worst.setdefault((name, tier), (0.0, 0, 0.0))
                if rel > w[0]:
                    worst[(name, tier)] = (rel, k, (got - want).abs().max().item())
    phase("K2-every-k", B=37, k="1..64",
          **{f"worst_rel_{n}_{t}": f"{v[0]:.3e}@k={v[1]}" for (n, t), v in worst.items()},
          tol_float32=1e-4, tol_float64=1e-10)
    return max(v[2] for (n, _), v in worst.items() if n == "float32")


# K2's shapes in the K2-speed line: the LMPC polish, the Van der Pol
# second-order correction, the oscillators' border, the blocked recursion's
# leaves (48), and the UGV path's KKT inverse (61), second-order correction
# (40) and polish capacitance (24) (UGV_K2_SHAPES)
K2_SPEED_SHAPES = ((B_MAIN, 24), (B_NL, ME_NL), (B_OSC, W_O), (256, 48), (256, 61), (256, 40),
                   (256, 24))
# K2 before its redesign (a warp a matrix, shared-memory chains) by
# "float32_B16384_k24" and so on: (device ms from a CUDA graph of launches,
# host us a call), that tree's K2 timed beside the redesigned one in one
# process (PERF.md §6, K2)
K2_MS_BEFORE = {
    "float32_B16384_k24": (0.21194, 15.25), "float64_B16384_k24": (0.34490, 19.17),
    "float32_B4096_k20": (0.04560, 15.03), "float64_B4096_k20": (0.07319, 18.78),
    "float32_B1024_k8": (0.00848, 13.67), "float64_B1024_k8": (0.00970, 20.81),
    "float32_B256_k48": (0.12925, 29.22), "float64_B256_k48": (0.15261, 13.48),
    "float32_B256_k61": (0.19155, 14.92), "float64_B256_k61": (0.22932, 14.90),
}


def k2_resources(log):
    """Registers, stack frame and spill bytes of each K2 kernel instance,
    from the ``-Xptxas -v`` lines of the build, keyed ``float32_kp24_g4``
    (register tier) or ``float32_block``."""
    import re
    out, cur = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            m = re.search(r"chol_inverse_(reg|block)_kernelI([fd])(?:Li(\d+)ELi(\d+)E)?", ln)
            cur = None
            if m:
                cur = ("float32" if m[2] == "f" else "float64") + (
                    f"_kp{m[3]}_g{m[4]}" if m[1] == "reg" else "_block")
        elif cur and "stack frame" in ln:
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", ln)
            out.setdefault(cur, {}).update(stack=int(m[1]), spill_stores=int(m[2]),
                                           spill_loads=int(m[3]))
        elif cur and "Used" in ln and "registers" in ln:
            out.setdefault(cur, {})["registers"] = int(re.search(r"Used (\d+) registers", ln)[1])
    return out


def k2_layout_key(bl, lay, dtype):
    name = str(dtype).split(".")[-1]
    return f"{name}_kp{lay.kp}_g{lay.g}" if lay.tier == bl.TIER_REGISTER else f"{name}_block"


def k2_layout_str(bl, lay):
    if lay.tier == bl.TIER_REGISTER:
        return (f"register(g={lay.g},kp={lay.kp},threads={lay.threads},grid={lay.grid},"
                f"{'staged,smem=' + str(lay.smem_bytes) if lay.stage else 'direct'})")
    return f"block(threads={lay.threads},grid={lay.grid},smem={lay.smem_bytes})"


K2_SPEED_REPS = 7  # interleaved repetitions of the kernel's and the empty kernel's graphs


def phase_k2_speed(torch, bl, card):
    """K2's speed at each of ``K2_SPEED_SHAPES`` in both types, one
    ``K2-speed`` line each: device ms from CUDA graphs of launches
    (:func:`graph_ms`) and an empty kernel's device ms on K2's grid measured
    the same way, ``K2_SPEED_REPS`` times each, interleaved (the medians,
    and the median and range of their differences), host us a call
    (:func:`host_us`), ms by CUDA events over back-to-back calls (the
    kernels line's ``ms``), the plain twin's and ``torch.linalg.inv``'s ms
    (events), the bound, the time before the redesign (``K2_MS_BEFORE``),
    the layout, and registers, stack and spills of the instance; each
    input's inverse is held to the twin's.  Then the blocked recursion at
    (256,302,302) float32 beside its twin, the library call and its bound,
    and a ``K2-resources`` line.  Returns the numbers by (B, k, type name)
    and, under "blocked", the blocked recursion's."""
    b = _build_mod()
    lib = b.library()
    res_regs = k2_resources(b.build_info.get("log", ""))
    fmt = lambda r: (f"{r.get('registers')}/{r.get('stack')}/{r.get('spill_stores')}/"
                     f"{r.get('spill_loads')}" if r else "not measured")
    empty = lambda lay: lib.libmpc_empty_launch(lay.grid, lay.threads,
                                                torch.cuda.current_stream().cuda_stream)
    med = lambda v: float(np.median(v))
    out = {}
    for B, k in K2_SPEED_SHAPES:
        for dtype, tol in ((torch.float32, 1e-4), (torch.float64, 1e-10)):
            name = str(dtype).split(".")[-1]
            key = f"{name}_B{B}_k{k}"
            C = torch.as_tensor(spd_batch(B, k, seed=B + k), dtype=dtype, device="cuda")
            lay = bl.layout(B, k, dtype)
            n = 20 if B * k * k > 2 ** 20 else 100
            call = lambda: bl.chol_inverse(C)
            require(_rel(call(), bl.chol_inverse_plain(C)) <= tol,
                    f"K2 {key} within {tol} of its twin")
            dev, emp = [], []
            for _ in range(K2_SPEED_REPS):
                dev.append(graph_ms(torch, call, n))
                emp.append(graph_ms(torch, lambda: empty(lay), n))
            over = [1e3 * (d - e) for d, e in zip(dev, emp)]
            row = dict(device_ms=med(dev), empty_ms=med(emp), over_empty_us=med(over),
                       over_empty_us_range=(min(over), max(over)),
                       host_us=host_us(torch, call), ms=cuda_ms(torch, call, reps=20),
                       plain_ms=cuda_ms(torch, lambda: bl.chol_inverse_plain(C), reps=10),
                       library_ms=cuda_ms(torch, lambda: torch.linalg.inv(C), reps=10))
            row["bound_ms"], row["bound_by"] = k2_bound_ms(B, k, C.element_size())
            before = K2_MS_BEFORE.get(key)
            phase("K2-speed", card=repr(card), shape=f"({B},{k},{k})", dtype=name,
                  device_ms=f"{row['device_ms']:.5f}", host_us_per_call=f"{row['host_us']:.2f}",
                  empty_kernel_device_ms=f"{row['empty_ms']:.5f}",
                  over_empty_us=f"{row['over_empty_us']:.3f}",
                  over_empty_us_range="{:.3f}..{:.3f}".format(*row["over_empty_us_range"]),
                  reps=K2_SPEED_REPS, events_ms=f"{row['ms']:.5f}",
                  plain_ms=f"{row['plain_ms']:.5f}", library_ms=f"{row['library_ms']:.5f}",
                  bound_ms=f"{row['bound_ms']:.6f}", bound_by=row["bound_by"],
                  before_device_ms="not measured" if before is None else f"{before[0]:.5f}",
                  before_host_us="not measured" if before is None else f"{before[1]:.2f}",
                  layout=k2_layout_str(bl, lay),
                  regs_stack_spill_st_ld=fmt(res_regs.get(k2_layout_key(bl, lay, dtype))))
            out[(B, k, name)] = row
    # the blocked recursion at the float32 dense interior point's oscillator size
    Bb, kb = K2_BLOCKED_SHAPES[0]
    C = torch.as_tensor(spd_batch(Bb, kb, seed=kb), dtype=torch.float32, device="cuda")
    call = lambda: bl.chol_inverse_blocked(C)
    blocked = dict(device_ms=graph_ms(torch, call, 10), host_us=host_us(torch, call, 50),
                   ms=cuda_ms(torch, call, reps=10),
                   plain_ms=cuda_ms(torch, lambda: bl.chol_inverse_plain(C), reps=5),
                   library_ms=cuda_ms(torch, lambda: torch.linalg.inv(C), reps=5))
    blocked["bound_ms"], blocked["bound_by"] = k2_bound_ms(Bb, kb)
    phase("K2-speed-blocked", card=repr(card), shape=f"({Bb},{kb},{kb})", dtype="float32",
          device_ms=f"{blocked['device_ms']:.5f}", host_us_per_call=f"{blocked['host_us']:.2f}",
          events_ms=f"{blocked['ms']:.5f}", plain_ms=f"{blocked['plain_ms']:.5f}",
          library_ms=f"{blocked['library_ms']:.5f}", bound_ms=f"{blocked['bound_ms']:.5f}",
          bound_by=blocked["bound_by"])
    phase("K2-resources", regs_stack_spill_st_ld=";".join(
        f"{k_}={fmt(v)}" for k_, v in sorted(res_regs.items())),
          build_seconds=f"{b.build_info.get('seconds', 0.0):.1f}")
    out["blocked"] = blocked
    return out


def phase_sweep_k2(torch, bl, card):
    """``--sweep-k2``: at each register-tier shape of ``K2_SPEED_SHAPES`` in
    both types, every other layout the library has forced (the other
    register instances, staged and not, and the block tier), each checked
    against the twin and timed as ``K2-speed`` times the layout's choice."""
    for B, k in K2_SPEED_SHAPES:
        if k > bl.REG_MAX_K:
            continue
        for dtype, tol in ((torch.float32, 1e-4), (torch.float64, 1e-10)):
            name = str(dtype).split(".")[-1]
            C = torch.as_tensor(spd_batch(B, k, seed=B + k), dtype=dtype, device="cuda")
            want = bl.chol_inverse_plain(C)
            lay = bl.layout(B, k, dtype)
            n = 20 if B * k * k > 2 ** 20 else 100
            lays = [bl.register_layout(B, k, dtype, g=g, stage=st)
                    for g in (1, 2, 4, 8, 16) for st in (False, True)]
            forced = {}
            for fl in [x for x in lays if x is not None] + [bl.block_layout(B, k, dtype)]:
                require(_rel(bl.launch(fl, C), want) <= tol, f"K2 {name} ({B},{k}) {fl}")
                fk = (f"g{fl.g}{'staged' if fl.stage else 'direct'}"
                      if fl.tier == bl.TIER_REGISTER else "block")
                forced[fk + ("(layout)" if fl == lay else "")] = graph_ms(
                    torch, lambda: bl.launch(fl, C), n)
            phase("K2-sweep", card=repr(card), shape=f"({B},{k},{k})", dtype=name,
                  device_ms="/".join(f"{fk}:{v:.5f}" for fk, v in forced.items()))


def phase_k2_ablate(torch, bl, card):
    """``--k2-ablate``: where the register tier's time goes.  Copies of
    ``csrc/chol_inverse.cu`` built with ``K2_ABLATE`` defined (1: loads and
    stores, no passes; 2: loads and passes, no stores; 3: loads alone) are
    timed beside the kernel (device ms, CUDA graphs) at each register-tier
    shape of ``K2_SPEED_SHAPES`` in both types, at the layout's choice.
    Diagnostic only: the path runs the kernel library."""
    src = (_build_mod().CSRC / "chol_inverse.cu").read_text()
    libs = {bits: variant_library("chol_inverse.cu", f"#define K2_ABLATE {bits}\n" + src,
                                  f"ablate{bits}") for bits in (1, 2, 3)}
    b = _build_mod()
    for B, k in K2_SPEED_SHAPES:
        if k > bl.REG_MAX_K:
            continue
        for dtype in (torch.float32, torch.float64):
            name = str(dtype).split(".")[-1]
            C = torch.as_tensor(spd_batch(B, k, seed=B + k), dtype=dtype, device="cuda")
            out = torch.empty_like(C)
            lay = bl.layout(B, k, dtype)
            entry = "libmpc_chol_inverse_f32" if dtype == torch.float32 else "libmpc_chol_inverse_f64"
            n = 20 if B * k * k > 2 ** 20 else 100
            ms = {"all": graph_ms(torch, lambda: bl.launch(lay, C), n)}
            for bits, lib in libs.items():
                fn = getattr(lib, entry)
                fn.argtypes = b._SIGNATURES[entry]
                fn.restype = int

                def call():
                    code = fn(C.data_ptr(), out.data_ptr(), B, k, lay.tier, lay.g, lay.threads,
                              lay.stage, torch.cuda.current_stream().cuda_stream)
                    require(code == 0, f"K2 variant {bits} launched ({code})")

                ms[{1: "loads_stores", 2: "loads_passes", 3: "loads"}[bits]] = graph_ms(
                    torch, call, n)
            phase("K2-ablate", card=repr(card), shape=f"({B},{k},{k})", dtype=name,
                  layout=k2_layout_str(bl, lay),
                  **{f"device_ms_{key}": f"{v:.5f}" for key, v in ms.items()})


def osc_engine(lt, sqp, c):
    """The inner engine ``ops/sqp.py`` routes this controller's solves to."""
    d = c.dims
    me = d.ph * d.nx + d.eq
    return sqp.inner_engine(c._params, c.dtype, d.nz, me + d.ineq + d.nz,
                            sqp.plan_applies(c._get_traj_plan(), c._params, d.nz, me, d.ineq))


def run_osc(torch, lt, tk, host, mods, B, K):
    """One oscillator closed loop through ``nlmpc_rollout`` from a cold start,
    float32, the shipped settings.  Returns the rollout, the launch counts,
    the interior-point iteration counts of every inner solve, (failed,
    rescued) lanes per step, host reads and wall seconds."""
    dev, f32 = "cuda", torch.float32
    x0_h, noise_h = osc_inputs(B, K)
    x0 = torch.as_tensor(x0_h, dtype=f32, device=dev)
    noise = torch.as_tensor(noise_h, dtype=f32, device=dev)
    c = osc_controller(lt, f32, dev, osc_params(lt))
    reset_counts(*mods)
    tk.ipm_solve.trace = []
    lt.nlmpc_rollout.rescued = []
    host.reads = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = lt.nlmpc_rollout(c, osc_plant(torch, noise), x0,
                         torch.zeros((B, NU_O), dtype=f32, device=dev), K)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(*mods)
    trace, tk.ipm_solve.trace = tk.ipm_solve.trace, None
    rescued, lt.nlmpc_rollout.rescued = lt.nlmpc_rollout.rescued, None
    ipm = torch.cat(trace).cpu().numpy()
    return c, r, launches, ipm, len(trace), rescued, host.reads, wall


def phase_main_osc(torch, lt, tk, sqp, qpf, host, mods):
    """The third main path: the networked-oscillators NLMPC closed loop at
    the example's own width (nz = 301) through the banded-KKT engine."""
    c, r, launches, ipm, n_ipm, rescued, reads, wall = run_osc(
        torch, lt, tk, host, mods, B_OSC, K_OSC)
    plan = c._get_traj_plan()
    require(plan == tk.TrajPlan(ph=PH_O, ch=CH_O, nx=NX_O, nu=NU_O, mi=MI_O),
            f"the probe verified the oscillators' banded structure, got {plan}")
    require((plan.nz, plan.bs, plan.bs_p, plan.w) == (NZ_O, BS_O, BSP_O, W_O), "plan widths")
    require(not qpf.supported(NZ_O, ME_O + MI_O + NZ_O), "nz = 301 is past the fused gate")
    engine = osc_engine(lt, sqp, c)
    require(engine == "riccati", f"the fused request is routed to riccati, got {engine}")
    require(tuple(r.inputs.shape) == (B_OSC, K_OSC, NU_O), "inputs shape (B, K, 6)")
    require(tuple(r.states.shape) == (B_OSC, K_OSC + 1, NX_O), "states shape (B, K+1, 12)")
    require(bool(torch.isfinite(r.inputs).all().item()), "commands finite")
    status = r.statuses.cpu().numpy()
    iters = r.iterations.cpu().numpy()
    for k in range(K_OSC):
        phase("osc-step", k=k, sqp_iters_mean=f"{iters[:, k].mean():.2f}",
              sqp_iters_max=int(iters[:, k].max()),
              success_frac=f"{(status[:, k] == 0).mean():.6f}",
              failed_lanes=rescued[k][0], rescued_lanes=rescued[k][1])
    mix = {lt.ResultStatus(int(v)).name: int(n)
           for v, n in zip(*np.unique(status, return_counts=True))}
    frac = float((status == 0).mean())
    cmd_max = r.inputs.max().item()
    n_launch = sum(launches.values())
    phase("main-osc", dtype="float32", B=B_OSC, steps=K_OSC, nz=NZ_O, engine=engine,
          success_frac=f"{frac:.6f}", jax_float32_record=OSC_JAX_SUCCESS[B_OSC],
          status_mix=json.dumps(mix).replace(" ", ""),
          rescued_per_step=json.dumps([n for _, n in rescued]).replace(" ", ""),
          sqp_iters_mean=f"{iters.mean():.2f}", sqp_iters_max=int(iters.max()),
          inner_solves=n_ipm, ipm_iters_mean=f"{ipm.mean():.2f}", ipm_iters_max=int(ipm.max()),
          cmd_max=f"{cmd_max:.7f}", launches_traj_factor=launches["traj_factor"],
          launches_traj_sweep=launches["traj_sweep"],
          launches_chol_inverse=launches["chol_inverse"],
          launches_qp_inner=launches["qp_inner"], launches_admm_fused=launches["admm_fused"],
          hand_written_launches_per_step=f"{n_launch / K_OSC:.1f}",
          host_reads=reads, host_reads_per_step=f"{reads / K_OSC:.1f}",
          wall_s=f"{wall:.3f}", solves_per_s=f"{B_OSC * K_OSC / wall:.1f}")
    require(launches["traj_factor"] > 0, "oscillator path launched K4")
    require(launches["traj_sweep"] >= 2 * launches["traj_factor"],
            "oscillator path launched K5 twice per factorization")
    require(launches["chol_inverse"] > 0, "oscillator path launched K2")
    require(launches["qp_inner"] == 0, "oscillator path did not launch K3")
    require(frac >= 0.99, f"oscillator success fraction {frac} >= 0.99")
    require(cmd_max <= 0.5 + 1e-5, f"commands never above 0.5 + 1e-5 (max {cmd_max})")
    # the success fraction at the other two batch sizes of the JAX records
    for B in (256, 512):
        _, rb, _, _, _, resc, _, wall_b = run_osc(torch, lt, tk, host, mods, B, 4)
        fb = float((rb.statuses == 0).float().mean().item())
        phase("osc-batch", B=B, steps=4, success_frac=f"{fb:.6f}",
              jax_float32_record=OSC_JAX_SUCCESS[B],
              rescued_per_step=json.dumps([n for _, n in resc]).replace(" ", ""),
              solves_per_s=f"{B * 4 / wall_b:.1f}")
        require(bool(torch.isfinite(rb.inputs).all().item()), f"commands finite at B={B}")
    return launches


def phase_matched_osc(torch, lt, sqp):
    """The oscillators have no float64 oracle file, so one is made here: 64
    lanes, a cold and a warm step, float64 ``riccati`` against float64
    ``pdip`` at the same states (commands within 1e-6, statuses and SQP
    iteration counts equal).  Then float32 with the shipped settings against
    that float64 result at the same states; its error is printed, not yet
    limited."""
    B = 64
    x0_h, noise_h = osc_inputs(B, 1)
    deep = dict(inner_iters=0, inner_iters_recovery=0, rescue_iters=0)
    f64 = torch.float64
    ric = osc_controller(lt, f64, "cuda", osc_params(lt, inner_qp="riccati", **deep))
    dense = osc_controller(lt, f64, "cuda", osc_params(lt, inner_qp="pdip", **deep))
    fast = osc_controller(lt, torch.float32, "cuda", osc_params(lt))
    require(osc_engine(lt, sqp, ric) == "riccati" and osc_engine(lt, sqp, dense) == "pdip"
            and osc_engine(lt, sqp, fast) == "riccati", "engines of the matched-state check")
    x = torch.as_tensor(x0_h, dtype=f64, device="cuda")
    u = torch.zeros((B, NU_O), dtype=f64, device="cuda")
    plant = osc_plant(torch, torch.as_tensor(noise_h, dtype=f64, device="cuda"))
    errs = []
    for step in ("cold", "warm"):
        rr, rd = ric.optimize(x, u), dense.optimize(x, u)
        rf = fast.optimize(x.float(), u.float())
        gap = (rr.cmd - rd.cmd).abs().max().item()
        same = (torch.equal(rr.status, rd.status)
                and torch.equal(ric._last_iters, dense._last_iters))
        e32 = (rf.cmd.double() - rr.cmd).abs().amax(dim=1).cpu().numpy()
        errs.append(e32)
        phase("matched-osc", step=step, B=B, riccati_vs_pdip_f64=f"{gap:.3e}", tol=1e-6,
              status_and_sqp_iters_equal=same,
              sqp_iters_f64=f"{ric._last_iters.float().mean().item():.2f}",
              success_f64=f"{(rr.status == 0).float().mean().item():.4f}",
              success_f32=f"{(rf.status == 0).float().mean().item():.4f}",
              f32_cmd_err_mean=f"{e32.mean():.3e}", f32_cmd_err_p99=f"{np.quantile(e32, 0.99):.3e}",
              f32_cmd_err_max=f"{e32.max():.3e}")
        require(gap <= 1e-6, f"float64 riccati within 1e-6 of float64 pdip ({step} step)")
        require(same, f"float64 riccati and pdip: statuses and SQP iterations equal ({step})")
        x, u = plant(x, rr.cmd, 0), rr.cmd
    return np.concatenate(errs)


def traj_factor_bound_ms(B, ph, bs, bs_p, w):
    """Least time for K4, float32.  Bytes: D, L, C, G read once, Sinv, X,
    Ghat written once.  Operations per stage, from the kernel's products:
    L S^-1 and (L S^-1) L' (4 bs^3), the three products with Z or U forward
    and the two backward (8 bs^2 w), Z' U (2 bs w^2), the two Cholesky
    inverses (p^3 + n^3) and the four products of the quasi-definite inverse
    (4 n p^2 + 4 n^2 p)."""
    n = bs - bs_p
    words = B * (ph * bs * bs + (ph - 1) * bs * bs + ph * bs * w + w * w
                 + ph * bs * bs + ph * bs * w + w * w)
    flops = B * ph * (4 * bs**3 + 8 * bs * bs * w + 2 * bs * w * w + bs_p**3 + n**3
                      + 4 * n * bs_p**2 + 4 * n * n * bs_p)
    return _bound(words, flops)


def traj_sweep_bound_ms(B, ph, bs, w):
    """Least time for K5, float32.  Bytes: Sinv, L, X, Ghat_inv, r_stage, r_g
    read once, xs and g written once (the kernel reads Sinv, L and X a second
    time on its way back, which the bound does not count).  Operations: four
    bs x bs and two bs x w matrix-vector products per stage, one w x w."""
    words = B * (ph * bs * bs + (ph - 1) * bs * bs + ph * bs * w + w * w
                 + 2 * ph * bs + 2 * w)
    flops = B * (ph * (8 * bs * bs + 4 * bs * w) + 2 * w * w)
    return _bound(words, flops)


# -- the UGV obstacle avoidance of examples/ugv_ex.cpp (bench.py:672-822) ----
B_UGV, K_UGV, CHUNK_UGV = 256, 150, 30
NZ_U, ME_U, MI_U = 61, 40, 22  # nz = 10 (nx + nu) + 1 slack; me = ph nx; mi = (ph + 1) 2
M_U = ME_U + MI_U + NZ_U  # 123 rows of the inner QP
UGV_K2_SHAPES = ((B_UGV, NZ_U), (B_UGV, ME_U), (B_UGV, 24))  # KKT, correction, capacitance
# the JAX package's float32 run on a TPU (BENCH_r05.json): its behaviour record,
# not this port's target
UGV_TPU_RECORD = {"goal_frac": 0.5, "avoid_frac": 1.0, "success_frac": 0.9996}
UGV_INNER_CAP_F32 = 500  # _qp_params(f32).maximum_iteration: 20 blocks of 25


def ugv_setup(torch, lt, dtype, B, device="cuda"):
    """bench.py:672-745 (``_make_ugv``): the batched UGV controller with its
    shipped float32 fleet settings (``inner_qp="admm"``, ``hessian_reg=
    "eigh"``), the per-lane velocity reference toward the goal recomputed
    from the state each step (``params_fn``), the plant, and the starts of
    ``default_rng(21)``."""
    kw = dict(dtype=dtype, device=device)
    A = np.zeros((4, 4))
    A[0:2, 2:4] = np.eye(2)
    Bm = np.zeros((4, 2))
    Bm[2:4, 0:2] = np.eye(2)
    Ad, Bd = (M.to(**kw) for M in lt.discretization(A, Bm, 0.1))
    obstacles = torch.tensor([[2.0, 1.0], [1.0, 1.0]], **kw)
    radii = torch.tensor([0.3, 0.3], **kw)
    yref = torch.tensor([2.0, 2.0], **kw)
    ph = 10
    c = lt.NLMPC(4, 2, 4, ph, ph, (ph + 1) * 2, 0, **kw)
    c.set_state_space_function(lambda x, u, k: Ad @ x + Bd @ u)
    c.set_output_function(lambda x, u, k: x)

    def objective(X, Y, U, e, p):
        v_err = X[:, 2:4] - p["v_pref"][None, :]
        return 1e3 * torch.sum(v_err ** 2) + 1e-2 * torch.sum(U ** 2) + 1e-5 * e * e

    def ineq(X, Y, U, e):
        d = torch.sqrt(torch.sum((X[:, None, 0:2] - obstacles[None, :, :]) ** 2, dim=-1))
        return (radii[None, :] - d).reshape(-1)

    c.set_objective_function(objective)
    c.set_ineq_con_function(ineq)
    c.set_runtime_params({"v_pref": torch.zeros((B, 2), **kw)}, batched=True)
    c.set_optimizer_parameters(lt.NLParameters(
        maximum_iteration=200, hard_constraints=False, enable_warm_start=True,
        inner_qp="admm", hessian_reg="eigh", relative_ftol=1e-6,
        cold_restart_on_failure=True))

    def params_fn(x, k):
        v = yref[None, :] - x[:, 0:2]
        return {"v_pref": v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                                          min=1e-9)}

    def plant(x, u, k):
        return x @ Ad.T + u @ Bd.T

    rng = np.random.default_rng(21)
    x0 = torch.as_tensor(np.concatenate([0.2 * rng.normal(size=(B, 2)), np.zeros((B, 2))],
                                        axis=1), **kw)
    return c, plant, params_fn, x0, (obstacles, radii, yref)


def run_ugv(torch, lt, c, plant, params_fn, x0, K, chunk=CHUNK_UGV):
    """bench.py:752-781: the closed loop as ``nlmpc_rollout`` calls of
    ``chunk`` steps chained at the host (state and last command carried; the
    warm start restarts cold at each chunk's first step).  Returns states
    (B, K+1, 4), inputs, statuses and SQP iterations (B, K)."""
    x, u = x0, torch.zeros((x0.shape[0], 2), dtype=x0.dtype, device=x0.device)
    pieces = []
    for n in [chunk] * (K // chunk) + ([K % chunk] if K % chunk else []):
        r = lt.nlmpc_rollout(c, plant, x, u, n, params_fn=params_fn)
        pieces.append(r)
        x, u = r.states[:, -1], r.inputs[:, -1]
    torch.cuda.synchronize()
    states = torch.cat([p.states[:, :-1] for p in pieces] + [pieces[-1].states[:, -1:]], dim=1)
    cat = lambda f: torch.cat([getattr(p, f) for p in pieces], dim=1).cpu().numpy()
    return states.cpu().numpy(), cat("inputs"), cat("statuses"), cat("iterations")


def ugv_fractions(states, statuses, geometry):
    """bench.py:806-822: goal reached (final position within 0.05 of the
    goal), obstacles avoided (closest approach at least r - 1e-2) and solve
    success, each as a fraction of the lanes (success of the lane-steps)."""
    obstacles, radii, yref = (np.asarray(g.cpu() if hasattr(g, "cpu") else g) for g in geometry)
    pos = states[:, :, 0:2]
    goal = np.linalg.norm(pos[:, -1] - yref, axis=-1) < 0.05
    dmin = np.linalg.norm(pos[:, :, None, :] - obstacles[None, None], axis=-1).min(axis=(1, 2))
    return {"goal_frac": float(goal.mean()),
            "avoid_frac": float((dmin >= float(radii[0]) - 1e-2).mean()),
            "success_frac": float((statuses == 0).mean())}


def ugv_oracle_fractions():
    """The float64 oracle's fractions (misc/results/ugv_closed_loop_ref_f64.npz:
    B = 32, gauss_newton curvature with the dense interior point, the same
    30-step chunks), read with numpy."""
    ref = np.load(ROOT / "misc" / "results" / "ugv_closed_loop_ref_f64.npz")
    geometry = (np.array([[2.0, 1.0], [1.0, 1.0]]), np.array([0.3, 0.3]), np.array([2.0, 2.0]))
    return int(ref["B"]), ugv_fractions(ref["states"], ref["statuses"], geometry)


def k2_by_shape(trace):
    """K2 launches grouped by (k, dtype), with the mean batch of each: the
    per-instance engine gathers the lanes still running, so B varies."""
    out = {}
    for B, k, dtype in trace:
        key = f"{k}x{k},{str(dtype).split('.')[-1]}"
        n, tot = out.get(key, (0, 0))
        out[key] = (n + 1, tot + B)
    return {key: {"launches": n, "mean_B": round(tot / n, 1)} for key, (n, tot) in out.items()}


def phase_main_ugv(torch, lt, admm, batched_linalg, host, mods):
    """The fourth main path: the UGV closed loop at the shipped float32
    configuration, B = 256 x 150 steps as five chained 30-step rollouts,
    through the per-instance inner ADMM (K2 at its three shapes)."""
    c, plant, params_fn, x0, geometry = ugv_setup(torch, lt, torch.float32, B_UGV)
    reset_counts(*mods)
    batched_linalg.chol_inverse.trace, admm.admm_solve_each.trace = [], []
    batched_linalg.eig_clip.launches = 0
    host.reads = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    states, inputs, statuses, iters = run_ugv(torch, lt, c, plant, params_fn, x0, K_UGV)
    wall = time.perf_counter() - t0
    launches = read_counts(*mods)
    k6_launches = batched_linalg.eig_clip.launches
    reads = host.reads
    shapes = k2_by_shape(batched_linalg.chol_inverse.trace)
    inner = admm.admm_solve_each.trace
    batched_linalg.chol_inverse.trace = admm.admm_solve_each.trace = None
    inner_iters = torch.cat([it for it, _ in inner]).cpu().numpy()
    frac = ugv_fractions(states, statuses, geometry)
    B0, oracle = ugv_oracle_fractions()
    require(states.shape == (B_UGV, K_UGV + 1, 4) and inputs.shape == (B_UGV, K_UGV, 2),
            "UGV states (B, K+1, 4) and inputs (B, K, 2)")
    require(bool(np.isfinite(inputs).all()), "UGV commands finite")
    mix = {lt.ResultStatus(int(v)).name: int(n)
           for v, n in zip(*np.unique(statuses, return_counts=True))}
    phase("main-ugv", dtype="float32", B=B_UGV, steps=K_UGV, chunks=f"{K_UGV // CHUNK_UGV}x{CHUNK_UGV}",
          goal_frac=f"{frac['goal_frac']:.4f}", avoid_frac=f"{frac['avoid_frac']:.4f}",
          success_frac=f"{frac['success_frac']:.6f}",
          status_mix=json.dumps(mix).replace(" ", ""),
          sqp_iters_mean=f"{iters.mean():.3f}", sqp_iters_max=int(iters.max()),
          inner_solves=len(inner), inner_lane_solves=inner_iters.size,
          inner_admm_iters_mean=f"{inner_iters.mean():.1f}",
          inner_at_cap_frac=f"{(inner_iters >= UGV_INNER_CAP_F32).mean():.4f}",
          inner_admm_iters=hist25(inner_iters),
          launches_chol_inverse=launches["chol_inverse"],
          k2_launches_per_step=f"{launches['chol_inverse'] / K_UGV:.1f}",
          k2_by_shape=json.dumps(shapes).replace(" ", ""),
          launches_eig_clip=k6_launches,
          host_reads=reads, host_reads_per_step=f"{reads / K_UGV:.1f}",
          wall_s=f"{wall:.3f}", wall_ms_per_step=f"{1e3 * wall / K_UGV:.1f}")
    phase("ugv-references", oracle_f64_B=B0,
          oracle_goal_frac=f"{oracle['goal_frac']:.4f}",
          oracle_avoid_frac=f"{oracle['avoid_frac']:.4f}",
          oracle_success_frac=f"{oracle['success_frac']:.4f}",
          tpu_reference_record="BENCH_r05.json(the_JAX_package_on_a_TPU,float32,B=256)",
          **{f"tpu_{k}": v for k, v in UGV_TPU_RECORD.items()})
    require(launches["chol_inverse"] > 0, "UGV main path launched K2")
    require(k6_launches > 0, "UGV main path launched K6")
    require(frac["avoid_frac"] == 1.0, f"UGV avoid fraction {frac['avoid_frac']} == 1.0")
    require(frac["success_frac"] >= 0.99, f"UGV success fraction {frac['success_frac']} >= 0.99")
    return launches, dict(frac, sqp_iters_mean=float(iters.mean()),
                          inner_iters_mean=float(inner_iters.mean()), k2_by_shape=shapes,
                          eig_clip_launches=k6_launches)


def ugv_first_qps(torch, lt, admm):
    """The inner QPs (B = 256, n = 61, m = 123) that the loop's first SQP
    iteration builds: the first step's solve, stopped after one SQP
    iteration, with the engine's arguments kept."""
    import dataclasses

    c, _plant, params_fn, x0, _ = ugv_setup(torch, lt, torch.float32, B_UGV)
    c.set_optimizer_parameters(dataclasses.replace(c._params, maximum_iteration=1))
    c.set_runtime_params(params_fn(x0, 0), batched=True)
    kept = []
    each = admm.admm_solve_each

    def keep(*args, **kw):
        kept.append((args, kw))
        return each(*args, **kw)

    keep.trace = None
    admm.admm_solve_each = keep
    try:
        c.optimize(x0, torch.zeros((B_UGV, 2), dtype=torch.float32, device="cuda"))
    finally:
        admm.admm_solve_each = each
    return kept[0]


def phase_ugv_engine_f64(torch, lt, admm, batched_linalg, sqp):
    """The per-instance engine in float64 on the card at the UGV shape: the
    first SQP iteration's QPs solved twice, through K2 and with
    ``batched_linalg``'s plain twin substituted for K2 inside this check
    only.  Statuses and iteration counts equal lane by lane, x within 1e-9
    as the CPU parity tests hold it (``allclose``: 1e-9 + 1e-9 |x| an
    entry; the directions reach |x| = 7, and the polish leaves each at the
    accuracy its six refinement passes reach, 1e-11 to 1e-9 apart between
    two inverses that round differently)."""
    (P, A, q, l, u), kw = ugv_first_qps(torch, lt, admm)
    d = lambda t: t.double()
    args = [d(t) for t in (P, A, q, l, u)]
    kw = dict(params=sqp._qp_params(False), eq_mask=kw["eq_mask"],
              warm_x=d(kw["warm_x"]), warm_y=d(kw["warm_y"]))
    require(tuple(A.shape) == (B_UGV, M_U, NZ_U), f"UGV inner QP shape {tuple(A.shape)}")
    before = batched_linalg.chol_inverse.launches
    sol_k = admm.admm_solve_each(*args, **kw)
    n_kernel = batched_linalg.chol_inverse.launches - before
    kernel = batched_linalg.chol_inverse
    batched_linalg.chol_inverse = batched_linalg.chol_inverse_plain
    try:
        sol_t = admm.admm_solve_each(*args, **kw)
    finally:
        batched_linalg.chol_inverse = kernel
    torch.cuda.synchronize()
    same_status = bool(torch.equal(sol_k.status, sol_t.status))
    same_iters = bool(torch.equal(sol_k.iters, sol_t.iters))
    err = (sol_k.x - sol_t.x).abs().max().item()
    ratio = ((sol_k.x - sol_t.x).abs() / (1e-9 + 1e-9 * sol_t.x.abs())).max().item()
    st = sol_k.status.cpu().numpy()
    phase("ugv-f64-engine", shape=f"B={B_UGV},n={NZ_U},m={M_U},float64",
          k2_launches=n_kernel, statuses_equal=same_status, iters_equal=same_iters,
          x_max_abs_err=f"{err:.3e}", x_err_over_tol=f"{ratio:.3f}", tol="1e-9+1e-9|x|",
          iters_mean=f"{sol_k.iters.float().mean().item():.1f}",
          iters_max=int(sol_k.iters.max()),
          status_mix=json.dumps({int(v): int(n) for v, n in
                                 zip(*np.unique(st, return_counts=True))}).replace(" ", ""),
          lanes_differing_iters=int((sol_k.iters != sol_t.iters).sum()))
    require(n_kernel > 0, "the float64 engine check launched K2")
    require(same_status and same_iters, "UGV float64 engine: K2 and twin statuses and iterations equal")
    require(ratio <= 1.0, f"UGV float64 engine: K2 and twin x within 1e-9 + 1e-9|x| "
                          f"(max abs {err:.3e}, {ratio:.3f} of the tolerance)")


def phase_k2_ugv(torch, batched_linalg):
    """K2 against its twin at the UGV path's three shapes (the KKT inverse
    (256,61,61) in its block tier, the second-order correction (256,40,40),
    the polish capacitance (256,24,24)) in both types; their ``K2-speed``
    lines time them.  Returns the largest error by (B, k, type name)."""
    err = {}
    for B, k in UGV_K2_SHAPES:
        for dtype, tol in ((torch.float32, 1e-4), (torch.float64, 1e-10)):
            C = torch.as_tensor(spd_batch(B, k, seed=k), dtype=dtype, device="cuda")
            inv_k = batched_linalg.chol_inverse(C)
            inv_t = batched_linalg.chol_inverse_plain(C)
            torch.cuda.synchronize()
            absmax = (inv_k - inv_t).abs().max().item()
            rel = absmax / inv_t.abs().max().item()
            name = str(dtype).split(".")[-1]
            lay = batched_linalg.layout(B, k, dtype)
            phase("K2-ugv", dtype=name, shape=f"({B},{k},{k})",
                  tier="register" if lay.tier == batched_linalg.TIER_REGISTER else "block",
                  rel_err=f"{rel:.3e}", max_abs_err=f"{absmax:.3e}", tol=tol)
            require(rel <= tol, f"K2 {name} ({B},{k},{k}) within {tol} of its twin")
            err[(B, k, name)] = absmax
    return err


def symmetric_batch(B, n, seed=0):
    """B symmetric indefinite matrices (X + X') / 2, X standard normal: the
    Jacobi sweeps they need are about the most a 61 x 61 UGV Hessian could."""
    X = np.random.default_rng(seed).normal(size=(B, n, n))
    return 0.5 * (X + np.transpose(X, (0, 2, 1)))


def k6_bound_ms(B, n, sweeps, elem):
    """K6's least time for B lanes at ``sweeps`` Jacobi sweeps a lane (the
    mean these inputs needed): a sweep's n (n - 1) / 2 rotations each turn
    two rows and two columns of A and two columns of V (6 n entries, 3 flops
    an entry), 9 n^2 (n - 1) flops; U U' 2 n^3; at the peak of the type
    (67 TFLOP/s both); the input read and the output written once."""
    flops = B * (sweeps * 9 * n * n * (n - 1) + 2 * n ** 3)
    t_ops = flops / (PEAK_FLOPS_F32 if elem == 4 else PEAK_FLOPS_F64)
    t_bytes = 2 * B * n * n * elem / PEAK_BYTES
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def cuda_kernels_a_call(torch, fn):
    """Device kernels one call of ``fn`` launches, from ``torch.profiler``'s
    CUDA rows."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(ev.count for ev in prof.key_averages()
               if str(ev.device_type).endswith("CUDA") and "memcpy" not in ev.key.lower()
               and "memset" not in ev.key.lower())


def phase_k6(torch, bl, card):
    """K6 against the float64 twin at the UGV's (256,61,61) in both types,
    then one ``K6-speed`` line a type: device ms (CUDA events over
    back-to-back launches; also at 128, 256 and 512 threads a block), the
    bound, the plain twin's ms, ``torch.linalg.eigh``'s ms and kernels a call,
    mean and largest sweeps, the largest relative Frobenius error against
    the float64 twin, registers and spills.  Returns the rows for the
    result line."""
    B, n = 256, 61
    res = kernel_resources(_build_mod().build_info.get("log", ""), "eig_clip_kernel")
    rows = {}
    for dtype, tol, elem in ((torch.float32, 2e-5, 4), (torch.float64, 1e-12, 8)):
        name = str(dtype).split(".")[-1]
        H = torch.as_tensor(symmetric_batch(B, n, seed=1), dtype=dtype, device="cuda")
        want = bl.eig_clip_plain(H.double())
        bl.eig_clip.trace = []
        launches = bl.eig_clip.launches
        out = bl.eig_clip(H)
        torch.cuda.synchronize()
        (sweeps,) = bl.eig_clip.trace
        bl.eig_clip.trace = None
        require(bl.eig_clip.launches == launches + 1, "eig_clip launched K6 once")
        err = float((torch.linalg.matrix_norm(out.double() - want)
                     / torch.linalg.matrix_norm(want)).max())
        require(err <= tol, f"K6 {name} within {tol} of the float64 twin, got {err:.3e}")
        mean_sw, max_sw = float(sweeps.double().mean()), int(sweeps.max())
        ms = cuda_ms(torch, lambda: bl.eig_clip(H), reps=20)
        by_threads = {t: cuda_ms(torch, lambda: bl._eig_clip_launch(H, t), reps=20)
                      for t in (128, 256, 512)}
        plain = cuda_ms(torch, lambda: bl.eig_clip_plain(H), reps=5)
        lib = cuda_ms(torch, lambda: torch.linalg.eigh(H), reps=5)
        lib_kernels = cuda_kernels_a_call(torch, lambda: torch.linalg.eigh(H))
        bound, by = k6_bound_ms(B, n, mean_sw, elem)
        phase("K6-speed", card=repr(card), dtype=name, shape=f"({B},{n},{n})",
              ms=f"{ms:.4f}", bound_ms=f"{bound:.5f}", bound_by=by,
              roofline_pct=f"{100 * bound / ms:.2f}",
              ms_by_threads={t: round(v, 4) for t, v in by_threads.items()},
              plain_ms=f"{plain:.3f}", eigh_ms=f"{lib:.3f}", eigh_kernels=lib_kernels,
              sweeps_mean=f"{mean_sw:.2f}", sweeps_max=max_sw, max_rel_err=f"{err:.3e}",
              tol=tol, resources=res.get(name))
        rows[name] = {"ms": ms, "bound_ms": bound, "bound_by": by, "plain_ms": plain,
                      "library_ms": lib, "library_kernels": lib_kernels,
                      "sweeps_mean": mean_sw, "sweeps_max": max_sw, "max_rel_err": err}
    return rows


# -- the batch-sharded fleets (libmpc_tpu_torch/parallel) -----------------------
B_FLEET_NL, K_FLEET_NL = 4096, 4  # Van der Pol fleet, one NCCL rank
K_FLEET_2R, B_FLEET_NL_2R, K_FLEET_NL_2R = 4, 1024, 2  # two gloo ranks sharing the card
FLEET_COLLECTIVE_S = 60  # every collective of the fleet phase
FLEET_RANKS_S = 300  # the two rank processes, start-up included


def same_cmds(torch, a, b) -> bool:
    """Bitwise-equal commands, NaN lanes (infeasible) matching NaN."""
    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all().item())


def stats_tuple(s):
    return (s.n_total, s.n_success, s.n_max_iteration, s.n_infeasible, s.n_error,
            s.n_unknown, s.mean_iterations, s.max_iterations)


def status_counts(status):
    """(n, SUCCESS, MAX_ITERATION, INFEASIBLE, ERROR, UNKNOWN) of a status vector."""
    return (int(status.numel()),) + tuple(int((status == s).sum().item()) for s in range(5))


def fleet_against_plain(torch, lt, par, mesh, kind, B, K, mods):
    """One closed loop through a fleet of ``kind`` ("lmpc": the quadrotor of
    the lmpc phase, seed 7; "nlmpc": Van der Pol with the nlmpc phase's
    settings, seed 11) on the whole batch, then one through the plain
    controller on this rank's rows of the same inputs.  Returns the per-step
    commands, statuses and stats, both walls, the fleet loop's launches, the
    loop's last (x, u) and the fleet."""
    dev, f32 = mesh.device, torch.float32
    rows = mesh.rows(B)
    if kind == "lmpc":
        Ad, Bd = quadrotor_model()
        Ad_t, Bd_t = (torch.as_tensor(a, dtype=f32, device=dev) for a in (Ad, Bd))
        x0_h, noise_h = closed_loop_inputs(B, K)
        make = lambda: quadrotor_controller(lt, f32, dev, closed_loop_params(lt))
        plant = lambda x, u, k, nz: x @ Ad_t.T + u @ Bd_t.T + nz[k]
        nu, fleet_cls = 4, par.LMPCFleet
    else:
        x0_h, noise_h = vdp_closed_loop_inputs(B, K)
        make = lambda: vdp_controller(lt, f32, dev, vdp_params(lt))
        plant = lambda x, u, k, nz: vdp_plant(torch, nz)(x, u, k)
        nu, fleet_cls = 1, par.NLMPCFleet
    x0 = torch.as_tensor(x0_h, dtype=f32, device=dev)
    noise = torch.as_tensor(noise_h, dtype=f32, device=dev)
    fleet = fleet_cls(make(), mesh)
    out = {"fleet_cmd": [], "fleet_status": [], "stats": [], "plain_cmd": [],
           "plain_status": []}

    def loop(opt, x, nz, cmd_key, status_key):
        u = torch.zeros((x.shape[0], nu), dtype=f32, device=dev)
        for k in range(K):
            r = opt(x, u)
            out[cmd_key].append(r.cmd)
            out[status_key].append(r.status)
            u = r.cmd
            x = plant(x, u, k, nz)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return x, u

    def fleet_step(x, u):
        r, s = fleet.optimize(x, u)
        out["stats"].append(s)
        return r

    # one untimed step of each beside the loops pays the one-time costs (the
    # collectives' first use, the controller's cache, first launches)
    u0 = torch.zeros((B, nu), dtype=f32, device=dev)
    fleet_cls(make(), mesh).optimize(x0, u0)
    make().optimize(x0[rows], u0[rows])
    reset_counts(*mods)
    t0 = time.perf_counter()
    out["x"], out["u"] = loop(fleet_step, x0, noise, "fleet_cmd", "fleet_status")
    out["fleet_wall"] = time.perf_counter() - t0
    out["launches"] = read_counts(*mods)
    plain = make()
    t0 = time.perf_counter()
    loop(plain.optimize, x0[rows], noise[:, rows], "plain_cmd", "plain_status")
    out["plain_wall"] = time.perf_counter() - t0
    out["fleet"], out["make"], out["rows"] = fleet, make, rows
    return out


def collective_ms(torch, fleet_mod, mesh, r, reps=20):
    """Host ms of one step's collectives (the stats reductions and the result
    gather) on this rank's rows of the loop's last step, the device
    synchronised."""
    from libmpc_tpu_torch.types import Result

    cmd, status = r["plain_cmd"][-1], r["plain_status"][-1]
    res = Result(cmd=cmd, cost=cmd[:, 0], status=status, solver_status=status,
                 is_feasible=status == 0)
    sync = lambda: torch.cuda.synchronize(mesh.device) if mesh.device.type == "cuda" else None
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        fleet_mod._local_stats(status, status, mesh, 0.0)
        fleet_mod._gather_result(mesh, res)
    sync()
    return 1e3 * (time.perf_counter() - t0) / reps


def fleet_resume_equal(torch, par, checkpoint, r, path):
    """save_fleet after the loop, load_fleet into a fresh fleet over a fresh
    controller, then one more step of each: equal to the bit."""
    checkpoint.save_fleet(r["fleet"], str(path))
    resumed = type(r["fleet"])(r["make"](), r["fleet"].mesh)
    checkpoint.load_fleet(resumed, str(path))
    a = r["fleet"].optimize(r["x"], r["u"])[0].cmd
    b = resumed.optimize(r["x"], r["u"])[0].cmd
    return same_cmds(torch, a, b)


def fleet_rank_main(rank, world, init, out_dir) -> int:
    """One of the two gloo ranks of the fleet phase: the quadrotor fleet
    (B=16384 x 4 steps) and the Van der Pol fleet (B=1024 x 2 steps), each
    rank's rows against the plain controller on those rows; writes
    ``rank<r>.npz``."""
    import torch

    from libmpc_tpu_torch import parallel as par
    from libmpc_tpu_torch.parallel import fleet as fleet_mod
    import libmpc_tpu_torch as lt
    from libmpc_tpu_torch.ops import admm_fused, batched_linalg
    from libmpc_tpu_torch.ops import qp_inner_fused as qpf
    from libmpc_tpu_torch.ops import trajectory_sweeps as ts

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    mods = (admm_fused, batched_linalg, qpf, ts)
    par.init_distributed(init, world, rank, backend="gloo", timeout=FLEET_COLLECTIVE_S)
    mesh = par.make_mesh()
    res = {}
    for kind, B, K in (("lmpc", B_MAIN, K_FLEET_2R), ("nlmpc", B_FLEET_NL_2R, K_FLEET_NL_2R)):
        r = fleet_against_plain(torch, lt, par, mesh, kind, B, K, mods)
        rows = r["rows"]
        res[f"{kind}_equal"] = np.array([same_cmds(torch, f[rows], p) for f, p in
                                         zip(r["fleet_cmd"], r["plain_cmd"])])
        res[f"{kind}_gathered"] = torch.stack(r["fleet_cmd"]).cpu().numpy()
        res[f"{kind}_plain"] = torch.stack(r["plain_cmd"]).cpu().numpy()
        res[f"{kind}_stats"] = np.array([stats_tuple(s) for s in r["stats"]], float)
        res[f"{kind}_plain_counts"] = np.array([status_counts(s) for s in r["plain_status"]])
        res[f"{kind}_walls"] = np.array([r["fleet_wall"], r["plain_wall"]])
        res[f"{kind}_collective_ms"] = np.array(collective_ms(torch, fleet_mod, mesh, r))
        del r
    torch.distributed.destroy_process_group()
    np.savez(Path(out_dir) / f"rank{rank}.npz", **res)
    return 0


def spawn_ranks(kind, world, tmp, limit_s, extra=()):
    """Re-run this script as ``world`` rank processes of ``kind`` ("fleet",
    "qp"; gloo unless ``extra`` asks otherwise) after this process built the
    kernel library, so the ranks load it; wait for them within ``limit_s``
    and return each rank's record."""
    procs, logs = [], []
    for r in range(world):
        log = open(tmp / f"rank{r}.log", "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), f"--{kind}-rank", str(r),
             "--ranks-world", str(world), "--ranks-init", f"file://{tmp / 'store'}",
             "--ranks-out", str(tmp), *extra],
            cwd=ROOT, stdout=log, stderr=subprocess.STDOUT))
    end = time.monotonic() + limit_s
    try:
        for p in procs:
            p.wait(timeout=max(1.0, end - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    for r, p in enumerate(procs):
        tail = (tmp / f"rank{r}.log").read_text()[-2000:]
        require(p.returncode == 0, f"{kind} rank {r} exited {p.returncode}:\n{tail}")
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(world)]


def phase_fleet(torch, lt, card, mods):
    """The fleets: one NCCL rank on the card (the quadrotor at B=16384 x 16
    steps and Van der Pol at B=4096 x 4 steps, each against the plain
    controller: commands equal to the bit, stats against the controller's
    statuses, success >= 0.999; save_fleet/load_fleet resumes to the bit),
    then two gloo ranks sharing the card (each rank's rows against the plain
    controller on those rows, the gathered result the concatenation of the
    shards, the stats global on both ranks)."""
    import tempfile

    from libmpc_tpu_torch import parallel as par
    from libmpc_tpu_torch.parallel import fleet as fleet_mod
    from libmpc_tpu_torch.utils import checkpoint

    t_phase = time.perf_counter()
    fields, launches = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_fleet_") as tmp:
        tmp = Path(tmp)
        par.init_distributed(f"file://{tmp / 'nccl_store'}", 1, 0, backend="nccl",
                             timeout=FLEET_COLLECTIVE_S)
        mesh = par.make_mesh()
        require(mesh.backend == "nccl" and mesh.device.type == "cuda",
                f"one NCCL rank on the card, got {mesh}")
        for kind, B, K in (("lmpc", B_MAIN, K_MAIN), ("nlmpc", B_FLEET_NL, K_FLEET_NL)):
            r = fleet_against_plain(torch, lt, par, mesh, kind, B, K, mods)
            for name, n in r["launches"].items():
                launches[name] = launches.get(name, 0) + n
            diff = max((f.float() - p.float()).abs().nan_to_num(0.0).max().item()
                       for f, p in zip(r["fleet_cmd"], r["plain_cmd"]))
            equal = all(same_cmds(torch, f, p) for f, p in zip(r["fleet_cmd"], r["plain_cmd"]))
            stats_ok = all(s.n_total == B and s.n_success == int((p == 0).sum().item())
                           for s, p in zip(r["stats"], r["plain_status"]))
            frac = float(torch.stack(r["fleet_status"]).eq(0).float().mean().item())
            resumed = fleet_resume_equal(torch, par, checkpoint, r, tmp / f"{kind}_fleet.npz")
            coll = collective_ms(torch, fleet_mod, mesh, r)
            fields.update({
                f"{kind}_B": B, f"{kind}_steps": K,
                f"{kind}_fleet_solves_per_s": f"{B * K / r['fleet_wall']:.1f}",
                f"{kind}_plain_solves_per_s": f"{B * K / r['plain_wall']:.1f}",
                f"{kind}_max_abs_diff": diff, f"{kind}_success_frac": f"{frac:.6f}",
                f"{kind}_collective_ms": f"{coll:.3f}", f"{kind}_resumed_equal": resumed})
            require(equal, f"{kind} fleet commands equal the controller's at every step")
            require(stats_ok, f"{kind} fleet stats: n_total {B}, n_success the controller's")
            require(frac >= 0.999, f"{kind} fleet success fraction {frac} >= 0.999")
            require(resumed, f"{kind} fleet resumed from save_fleet/load_fleet equals the "
                             "uninterrupted one")
            del r
        require(launches["admm_fused"] > 0 and launches["chol_inverse"] > 0
                and launches["qp_inner"] > 0, f"the fleet path launched K1, K2, K3: {launches}")
        torch.distributed.destroy_process_group()
        torch.cuda.empty_cache()

        two = spawn_ranks("fleet", 2, tmp, FLEET_RANKS_S)
        for kind, B, K in (("lmpc", B_MAIN, K_FLEET_2R), ("nlmpc", B_FLEET_NL_2R, K_FLEET_NL_2R)):
            require(all(t[f"{kind}_equal"].all() for t in two),
                    f"two gloo ranks: each {kind} shard equals the controller on its rows")
            concat = np.concatenate([t[f"{kind}_plain"] for t in two], axis=1)
            require(all(np.array_equal(t[f"{kind}_gathered"], concat, equal_nan=True)
                        for t in two), f"{kind} gathered result is the shards' concatenation")
            counts = sum(t[f"{kind}_plain_counts"] for t in two)
            for t in two:
                require(np.array_equal(t[f"{kind}_stats"][:, :6], counts),
                        f"{kind} stats on every rank are the sums of the halves")
                require(np.array_equal(t[f"{kind}_stats"], two[0][f"{kind}_stats"]),
                        f"{kind} stats equal on both ranks")
            walls = np.max([t[f"{kind}_walls"] for t in two], axis=0)
            fields.update({
                f"gloo2_{kind}_B": B, f"gloo2_{kind}_steps": K,
                f"gloo2_{kind}_fleet_solves_per_s": f"{B * K / walls[0]:.1f}",
                f"gloo2_{kind}_plain_half_solves_per_s": f"{B // 2 * K / walls[1]:.1f}",
                f"gloo2_{kind}_collective_ms": f"{max(float(t[f'{kind}_collective_ms']) for t in two):.3f}"})
    phase("fleet", card=repr(card), **fields,
          launches_admm_fused=launches["admm_fused"],
          launches_chol_inverse=launches["chol_inverse"],
          launches_qp_inner=launches["qp_inner"],
          wall_s=f"{time.perf_counter() - t_phase:.1f}")
    return launches


# -- the row-sharded QP (libmpc_tpu_torch/parallel/qp_sharded.py) ----------------
B_QPS_SMALL = 1024  # the float64 comparisons and the gloo ranks
QPS_GLOO_PARTS = (("b", (1, 2)), ("c", (2, 2)))  # (data, model) of gloo ranks sharing the card
QPS_RANKS_S = 240  # each spawn of rank processes, start-up included


def qps_inputs(B):
    """The quadrotor QP's states: ``closed_loop_inputs``'s, lane 0 at x0 = 0
    (the golden lane), last commands 0."""
    x0, _ = closed_loop_inputs(B, 1)
    x0[0] = 0.0
    return x0, np.zeros((B, 4))


def qps_success(status):
    """The share of lanes the LMPC maps to SUCCESS by a solved status."""
    return float(((status == 1) | (status == 2)).float().mean().item())


def qps_run(torch, lt, par, mesh, dtype, B, mods, params=None):
    """``solve_sharded`` of the quadrotor QP at B lanes on ``mesh``, once
    untimed (the collectives' and libraries' first use), then once timed:
    the solution, its first commands, the wall ms of the solve, the
    collectives' count and host ms in it and the kernel launches."""
    from libmpc_tpu_torch.parallel import mesh as mesh_lib

    x0, u0 = qps_inputs(B)
    P, A, q, l, u, eq, cmd = quadrotor_qp(torch, lt, dtype, mesh.device, x0, u0)
    params = params or closed_loop_params(lt)
    solve = lambda: par.solve_sharded(P, A, q, l, u, mesh, params, eq_mask=eq)
    solve()
    torch.cuda.synchronize()
    reset_counts(*mods)
    mesh_lib.all_reduce.calls, mesh_lib.all_reduce.seconds = 0, 0.0
    t0 = time.perf_counter()
    sol = solve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return dict(sol=sol, cmd=cmd(sol.x), wall_ms=1e3 * wall,
                collectives=mesh_lib.all_reduce.calls,
                collective_ms=1e3 * mesh_lib.all_reduce.seconds,
                launches=read_counts(*mods), qp=(P, A, q, l, u, eq, cmd))


QPS_NUMBERS = ("wall_ms", "collectives", "collective_ms", "iters_mean", "iters_max",
               "k1_launches")


def qps_numbers(r):
    """A ``qps_run`` result's numbers, in the order of ``QPS_NUMBERS``."""
    it = r["sol"].iters.double()
    return np.array([r["wall_ms"], r["collectives"], r["collective_ms"], it.mean().item(),
                     it.max().item(), r["launches"]["admm_fused"]])


def qps_fields(tag, numbers):
    fmt = ("{:.1f}", "{:.0f}", "{:.1f}", "{:.2f}", "{:.0f}", "{:.0f}")
    return {f"{tag}_{k}": f.format(v) for k, f, v in zip(QPS_NUMBERS, fmt, numbers)}


def qps_rank_main(rank, world, init, out_dir, shape, B=B_QPS_SMALL, backend="gloo") -> int:
    """One rank of the qp_sharded phase on a (data, model) = ``shape`` mesh
    (gloo ranks share card 0; NCCL ranks take a card each): the float64 and
    the float32 quadrotor QP at B lanes; writes the global solutions,
    commands, times and counts to ``rank<r>.npz``."""
    import torch

    from libmpc_tpu_torch import parallel as par
    import libmpc_tpu_torch as lt
    from libmpc_tpu_torch.ops import admm_fused, batched_linalg
    from libmpc_tpu_torch.ops import qp_inner_fused as qpf
    from libmpc_tpu_torch.ops import trajectory_sweeps as ts

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    mods = (admm_fused, batched_linalg, qpf, ts)
    par.init_distributed(init, world, rank, backend=backend, timeout=FLEET_COLLECTIVE_S)
    mesh = par.make_mesh(*shape)
    res = {}
    for tag, dtype in (("f64", torch.float64), ("f32", torch.float32)):
        r = qps_run(torch, lt, par, mesh, dtype, B, mods)
        for f in ("x", "y", "status", "iters"):
            res[f"{tag}_{f}"] = getattr(r["sol"], f).cpu().numpy()
        res[f"{tag}_cmd"] = r["cmd"].cpu().numpy()
        res[f"{tag}_numbers"] = qps_numbers(r)
    torch.distributed.destroy_process_group()
    np.savez(Path(out_dir) / f"rank{rank}.npz", **res)
    return 0


def phase_qp_sharded(torch, lt, admm, card, mods, nccl_cards=0):
    """The row-sharded QP on the quadrotor QP (n=216, m=535) with the
    closed-loop settings (under rows the shared polish becomes the dense
    one), through ``parallel.solve_sharded``:

    (a) one NCCL rank, mesh (1, 1): float32 at B=16384 (success >= 0.999,
        the x0 = 0 lane's command within 1e-4 of the golden, the commands
        within p99 1e-4 of the unsharded float64 ``admm_solve`` at the same
        states), beside the unsharded float32 ``admm_solve`` (K1's path);
        float64 at B=1024 against the unsharded solve with
        ``use_pallas=False``, ``polish_mode="dense"``,
        ``compact_stragglers=False`` (statuses and iterations equal, x
        within 1e-12);
    (b), (c) two gloo ranks on (1, 2) and four on (2, 2) sharing the card at
        B=1024: float64 statuses and iterations equal to (a)'s float64, x
        and y within 1e-9; float32 golden within 1e-4 and success >= 0.999;
        every rank's global solution the same to the bit.

    With ``nccl_cards`` N (``--qp-nccl N``, on a machine with N cards) parts
    (d) on (1, N) and (e) on (2, N / 2), NCCL ranks a card each, replace (b)
    and (c), with the same gates.  The host ms of NCCL collectives are
    their enqueue.

    K1 launches on the sharded path: 0, as the JAX package's XLA loop
    there.  Returns the sharded path's kernel launches (all 0)."""
    import dataclasses
    import tempfile

    from libmpc_tpu_torch import parallel as par

    t_phase = time.perf_counter()
    fields = {}
    f32, f64 = torch.float32, torch.float64
    with tempfile.TemporaryDirectory(prefix="chip_smoke_qps_") as tmp:
        tmp = Path(tmp)
        par.init_distributed(f"file://{tmp / 'nccl_store'}", 1, 0, backend="nccl",
                             timeout=FLEET_COLLECTIVE_S)
        mesh = par.make_mesh(1, 1)
        require(mesh.backend == "nccl" and mesh.device.type == "cuda",
                f"one NCCL rank on the card, got {mesh}")

        # (a) float32 at the main path's batch
        r = qps_run(torch, lt, par, mesh, f32, B_MAIN, mods)
        launches = r["launches"]
        P, A, q, l, u, eq, _ = r["qp"]
        frac = qps_success(r["sol"].status)
        golden = float((r["cmd"][0].double().cpu() - torch.as_tensor(GOLDEN_CMD)).abs().max())
        x0, u0 = qps_inputs(B_MAIN)
        P6, A6, q6, l6, u6, eq6, cmd6 = quadrotor_qp(torch, lt, f64, "cuda", x0, u0)
        ref = admm.admm_solve(P6, A6, q6, l6, u6, closed_loop_params(lt), eq_mask=eq6)
        err = (r["cmd"].double() - cmd6(ref.x)).abs().amax(1).cpu().numpy()
        p99 = float(np.quantile(err, 0.99))
        del ref, P6, A6, q6, l6, u6
        plain = lambda: admm.admm_solve(P, A, q, l, u, closed_loop_params(lt), eq_mask=eq)
        plain()
        torch.cuda.synchronize()
        reset_counts(*mods)
        t0 = time.perf_counter()
        plain()
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.perf_counter() - t0)
        plain_k1 = read_counts(*mods)["admm_fused"]
        fields.update(B=B_MAIN, **qps_fields("a_f32", qps_numbers(r)),
                      a_f32_success_frac=f"{frac:.6f}",
                      a_f32_golden_err=f"{golden:.3e}",
                      a_f32_cmd_err_vs_f64_p99=f"{p99:.3e}",
                      a_f32_cmd_err_vs_f64_max=f"{err.max():.3e}",
                      a_unsharded_f32_wall_ms=f"{plain_ms:.1f}",
                      a_unsharded_f32_k1_launches=plain_k1)
        require(frac >= 0.999, f"(a) float32 success share {frac} >= 0.999")
        require(golden <= 1e-4, f"(a) float32 golden lane within 1e-4: {golden}")
        require(p99 <= 1e-4, f"(a) float32 commands within p99 1e-4 of float64: {p99}")
        require(launches["admm_fused"] == 0, "the sharded path launches no K1")
        del r, P, A, q, l, u, plain
        torch.cuda.empty_cache()

        # (a) float64 at B=1024 against the unsharded solve on the same path
        base = dataclasses.replace(closed_loop_params(lt), use_pallas=False,
                                   polish_mode="dense", compact_stragglers=False)
        a64 = qps_run(torch, lt, par, mesh, f64, B_QPS_SMALL, mods)
        P, A, q, l, u, eq, _ = a64["qp"]
        ref = admm.admm_solve(P, A, q, l, u, base, eq_mask=eq)
        s64 = a64["sol"]
        same = (torch.equal(s64.status, ref.status) and torch.equal(s64.iters, ref.iters))
        dx = float((s64.x - ref.x).abs().max())
        fields.update(**qps_fields("a_f64", qps_numbers(a64)), a_f64_x_vs_unsharded=f"{dx:.3e}")
        require(same, "(a) float64 statuses and iterations equal the unsharded solve's")
        require(dx <= 1e-12, f"(a) float64 x within 1e-12 of the unsharded solve: {dx}")
        require(a64["launches"]["admm_fused"] == 0, "the sharded path launches no K1")
        torch.distributed.destroy_process_group()
        torch.cuda.empty_cache()

        # (b), (c) gloo ranks sharing the card, or (d), (e) NCCL ranks a card each
        parts = [(p_, s_, "gloo") for p_, s_ in QPS_GLOO_PARTS]
        if nccl_cards:
            require(torch.cuda.device_count() >= nccl_cards,
                    f"--qp-nccl {nccl_cards} needs {nccl_cards} cards")
            parts = [("d", (1, nccl_cards), "nccl"), ("e", (2, nccl_cards // 2), "nccl")]
        for part, shape, backend in parts:
            world = shape[0] * shape[1]
            sub = tmp / f"ranks{part}"
            sub.mkdir()
            recs = spawn_ranks("qp", world, sub, QPS_RANKS_S,
                               ("--qp-mesh", ",".join(map(str, shape)), "--qp-backend", backend))
            got = recs[0]
            for r_ in recs:
                require(all(np.array_equal(r_[k], got[k], equal_nan=True)
                            for k in got if not k.endswith("_numbers")),
                        f"({part}) every rank returns the same global solution")
            dx = float(np.abs(got["f64_x"] - s64.x.cpu().numpy()).max())
            dy = float(np.abs(got["f64_y"] - s64.y.cpu().numpy()).max())
            same = (np.array_equal(got["f64_status"], s64.status.cpu().numpy())
                    and np.array_equal(got["f64_iters"], s64.iters.cpu().numpy()))
            st32 = torch.as_tensor(got["f32_status"])
            frac = qps_success(st32)
            golden = float(np.abs(got["f32_cmd"][0] - GOLDEN_CMD).max())
            # the slowest rank's numbers (the iterations are global)
            nums = {tag: np.max([r_[f"{tag}_numbers"] for r_ in recs], axis=0)
                    for tag in ("f64", "f32")}
            for tag, n_ in nums.items():
                fields.update(qps_fields(f"{part}_{tag}", n_))
            fields.update({f"{part}_mesh": "x".join(map(str, shape)), f"{part}_backend": backend,
                           f"{part}_f64_x_vs_a": f"{dx:.3e}", f"{part}_f64_y_vs_a": f"{dy:.3e}",
                           f"{part}_f32_success_frac": f"{frac:.6f}",
                           f"{part}_f32_golden_err": f"{golden:.3e}"})
            require(same, f"({part}) float64 statuses and iterations equal (a)'s")
            require(dx <= 1e-9 and dy <= 1e-9, f"({part}) float64 x, y within 1e-9 of (a)'s: "
                                               f"{dx}, {dy}")
            require(golden <= 1e-4, f"({part}) float32 golden lane within 1e-4: {golden}")
            require(frac >= 0.999, f"({part}) float32 success share {frac} >= 0.999")
            k1 = QPS_NUMBERS.index("k1_launches")
            require(nums["f64"][k1] == 0 and nums["f32"][k1] == 0,
                    f"({part}) the sharded path launches no K1")
    phase("qp_sharded", card=repr(card), **fields,
          wall_s=f"{time.perf_counter() - t_phase:.1f}")
    return launches


# -- the user surface: the pympcxx layer, the six examples, the QP oracle ------
EXAMPLES = ROOT / "examples" / "torch"
SURFACE_EXAMPLES = ("quadrotor_ex", "vanderpol_ex", "networked_oscillators_ex", "ugv_ex",
                    "fleet_ex", "serving_ex")
# x'x after the oscillator example's 10 steps in float64, the same to the
# last digit in both packages on the CPU (the example from the state
# [1, 0, ..., 0], x'x = 1: the capped controller lets it rise).  Float32 runs
# land within 0.4 % of it (the JAX package's 1.26948, the port's 1.26996)
OSC_EX_ENERGY_F64 = 1.2657496740804706
# the oracle test's settings (tests/test_native_oracle.py::TIGHT)
ORACLE_PARAMS = dict(maximum_iteration=4000, eps_abs=1e-9, eps_rel=1e-9)


def load_example(name):
    """``examples/torch/<name>.py`` as the module ``torch_example_<name>``.

    While it loads, an example's ``from quadrotor_ex import ...`` resolves to
    the torch quadrotor example beside it, whatever module of that name is
    already imported (the JAX package's examples have the same names)."""
    import importlib.util

    key = f"torch_example_{name}"
    if key in sys.modules:
        return sys.modules[key]
    siblings = {} if name == "quadrotor_ex" else {"quadrotor_ex": load_example("quadrotor_ex")}
    spec = importlib.util.spec_from_file_location(key, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    saved = {k: sys.modules.get(k) for k in siblings}
    sys.modules.update(siblings)
    try:
        spec.loader.exec_module(mod)
    finally:
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k)
            else:
                sys.modules[k] = v
    sys.modules[key] = mod
    return mod


def to_numpy(a) -> np.ndarray:
    """A tensor or a JAX array as a numpy array."""
    return a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)


def compat_quadrotor(mpc, **kw):
    """tests/test_compat.py:64-101, the quadrotor golden, through a pympcxx
    surface ``mpc`` (the port's ``compat`` with ``kw`` its dtype and device,
    or the JAX package's): (result, optimal sequence)."""
    Tnx, Tnu, Tndu, Tny, Tph, Tch = 12, 4, 4, 12, 10, 10
    lmpc = mpc.LMPC(Tnx, Tnu, Tndu, Tny, Tph, Tch, **kw)
    Ad, Bd = quadrotor_model()
    require(lmpc.setStateSpaceModel(Ad, Bd, np.eye(12)), "setStateSpaceModel")
    OutputW = np.array([0, 0, 10, 10, 10, 10, 0, 0, 0, 5, 5, 5], float)
    require(lmpc.setObjectiveWeights(OutputW, np.full(4, 0.1), np.zeros(4),
                                     mpc.HorizonSlice(0, Tph)), "setObjectiveWeights")
    inf = float("inf")
    xmin = np.array([-np.pi / 6, -np.pi / 6, -inf, -inf, -inf, -1,
                     -inf, -inf, -inf, -inf, -inf, -inf])
    xmax = np.array([np.pi / 6, np.pi / 6] + [inf] * 10)
    u0 = 10.5916
    require(lmpc.setStateBounds(xmin, xmax, mpc.HorizonSlice(0, Tph)), "setStateBounds")
    require(lmpc.setInputBounds(np.full(4, 9.6 - u0), np.full(4, 13.0 - u0),
                                mpc.HorizonSlice(0, Tch)), "setInputBounds")
    yRef = np.zeros(12)
    yRef[2] = 1.0
    require(lmpc.setReferences(yRef, np.zeros(4), np.zeros(4), mpc.HorizonSlice(0, Tph)),
            "setReferences")
    params = mpc.LParameters()
    params.maximum_iteration = 250
    lmpc.setOptimizerParameters(params)
    res = lmpc.optimize(np.zeros(12), np.zeros(4))
    return res, lmpc.getOptimalSequence()


def compat_example_nl(mpc, xp, steps=200, **kw):
    """tests/test_compat.py:13-60, the reference's python/examples/example_nl.py,
    through a pympcxx surface ``mpc`` with callbacks written in ``xp``
    (``torch`` for the port, ``jax.numpy`` for the JAX package), for at most
    ``steps`` closed-loop steps or until it converges: (steps run, whether it
    converged, the commands, the execution stats)."""
    nx, nu, ny = 2, 1, 2
    ph, ch = 10, 5
    ineq_c, eq = ph + 1, 0
    ts = 0.1

    nlmpc = mpc.NLMPC(nx, nu, ny, ph, ch, ineq_c, eq, **kw)
    nlmpc.setLoggerLevel(mpc.LoggerLevel.NONE)
    nlmpc.setDiscretizationSamplingTime(ts)

    def state_space(x, u, i):
        return xp.stack([(1.0 - x[1] * x[1]) * x[0] - x[1] + u[0], x[0]])

    def cost(x, y, u, slack):
        return xp.sum(xp.square(x)) + xp.sum(xp.square(u))

    def ineq_con(x, y, u, slack):
        return u[:, 0] - 0.5

    nlmpc.setStateSpaceFunction(state_space, 1e-10)
    nlmpc.setObjectiveFunction(cost)
    nlmpc.setIneqConFunction(ineq_con, 1e-10)
    params = mpc.NLParameters()
    params.maximum_iteration = 200
    nlmpc.setOptimizerParameters(params)

    m_x = np.array([0.0, 1.0])
    m_u = np.array([0.0])
    cmds, converged = [], False
    for step in range(steps):
        res = nlmpc.optimize(m_x, m_u)
        m_u = to_numpy(res.cmd).astype(float)
        cmds.append(m_u)
        dx = np.array([(1.0 - m_x[1] ** 2) * m_x[0] - m_x[1] + m_u[0], m_x[0]])
        m_x = m_x + dx * ts
        if abs(m_x[0]) <= 1e-2 and abs(m_x[1]) <= 1e-1:
            converged = True
            break
    return step + 1, converged, np.array(cmds), nlmpc.getExecutionStats()


def oracle_quadrotor(torch, lt, device):
    """tests/test_native_oracle.py::test_quadrotor_qp_agreement on ``device``:
    the quadrotor QP at x0 = 0 solved by the port's float64 ``admm_solve``
    and by the native oracle: (max |x - oracle x|, the oracle's status, its
    iterations, the oracle's first command's distance from the golden, the
    solver's iterations)."""
    from libmpc_tpu_torch import native_qp
    from libmpc_tpu_torch.ops import admm

    f64 = torch.float64
    P, A, q, l, u, eq_mask, cmd = quadrotor_qp(torch, lt, f64, device, np.zeros((1, 12)),
                                               np.zeros((1, 4)))
    sol = admm.admm_solve(P, A, q[0], l[0], u[0], lt.LParameters(**ORACLE_PARAMS),
                          eq_mask=eq_mask)
    ref = native_qp.solve(P, A, q[0], l[0], u[0])
    dx = float(np.abs(to_numpy(sol.x) - ref.x).max())
    ref_cmd = to_numpy(cmd(torch.as_tensor(ref.x, dtype=f64, device=device)[None]))[0]
    golden = float(np.abs(ref_cmd - GOLDEN_CMD).max())
    return dx, ref.status, ref.iters, golden, int(sol.iters)


def surface_parts(torch, lt, mods, device):
    """Run every part of the surface on ``device``, each with its gates;
    returns {part: record}, each record with its wall seconds, the lines the
    part printed (kept out of this script's output) and, on the card, its
    kernel launches."""
    import contextlib
    import io

    import libmpc_tpu_torch.compat as mpc
    from libmpc_tpu_torch.utils.logger import Logger

    parts = {}
    log = Logger.instance()

    def run(part, fn):
        out = io.StringIO()
        level = log.level  # the examples set the process-wide logger's level
        log.set_stream(out)
        reset_counts(*mods)
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(out):
                got = fn()
            if device == "cuda":
                torch.cuda.synchronize()
        finally:
            log.set_stream(sys.stdout)
            log.set_level(level)
        parts[part] = {"wall_s": round(time.perf_counter() - t0, 3),
                       "printed_lines": len(out.getvalue().splitlines()),
                       "launches": read_counts(*mods)}
        return got

    # (a) the quadrotor golden through the pympcxx layer
    for dtype in (torch.float32, torch.float64):
        tag = f"compat_quadrotor_{str(dtype)[6:]}"
        res, seq = run(tag, lambda: compat_quadrotor(mpc, dtype=dtype, device=device))
        err = float(np.abs(to_numpy(res.cmd) - GOLDEN_CMD).max())
        parts[tag].update(golden_err=err, status=res.status_enum.name)
        require(err <= 1e-4, f"{tag}: golden within 1e-4 ({err})")
        require(res.status_enum == mpc.SUCCESS, f"{tag}: status SUCCESS")
        require(tuple(seq.state.shape) == (11, 12), f"{tag}: optimal state sequence (11, 12)")
    # (b) the reference's example_nl loop through the pympcxx layer
    steps, converged, cmds, stats = run("compat_example_nl",
                                        lambda: compat_example_nl(mpc, torch, device=device))
    parts["compat_example_nl"].update(steps=steps, converged=converged,
                                      cmd_max=float(cmds.max()),
                                      number_of_solutions=stats.number_of_solutions)
    require(converged, "compat example_nl converged within 200 steps")
    require(stats.number_of_solutions == steps, "compat example_nl counts one solution a step")
    require(cmds.max() <= 0.5 + 1e-5, f"compat example_nl commands <= 0.5 + 1e-5 ({cmds.max()})")

    # (c) the six examples, each main() as shipped
    ex = {name: load_example(name) for name in SURFACE_EXAMPLES}
    res, res_b = run("quadrotor_ex", lambda: ex["quadrotor_ex"].main(device=device))
    status = to_numpy(res_b.status)
    parts["quadrotor_ex"].update(status=res.status_enum.name, batch=len(status),
                                 batch_success=int((status == 0).sum()))
    require(bool(res_b.is_feasible.all()), "quadrotor_ex: every lane of the batch feasible")

    steps, x, cmds = run("vanderpol_ex", lambda: ex["vanderpol_ex"].main(device=device))
    done = abs(x[0]) <= 1e-2 and abs(x[1]) <= 1e-1
    parts["vanderpol_ex"].update(steps=steps, converged=bool(done), cmd_max=float(cmds.max()))
    require(done, f"vanderpol_ex converged ({x})")

    steps, x0, x, cmds = run("networked_oscillators_ex",
                             lambda: ex["networked_oscillators_ex"].main(device=device))
    e0, e1 = float(np.sum(x0**2)), float(np.sum(x**2))
    e_rel = abs(e1 / OSC_EX_ENERGY_F64 - 1.0)
    parts["networked_oscillators_ex"].update(steps=steps, cmd_max=float(cmds.max()),
                                             energy_start=e0, energy_end=e1,
                                             energy_vs_f64=e_rel)
    require(cmds.max() <= 0.5 + 1e-5, f"oscillators: commands <= 0.5 + 1e-5 ({cmds.max()})")
    require(e_rel <= 1e-2, f"oscillators: energy {e1} within 1% of the float64 run's")

    traj, obstacles, radii, goal = run("ugv_ex", lambda: ex["ugv_ex"].main(device=device))
    miss = float(np.linalg.norm(traj[-1] - goal))
    dmin = [float(np.linalg.norm(traj - o, axis=1).min()) for o in obstacles]
    parts["ugv_ex"].update(steps=len(traj) - 1, goal_dist=miss, obstacle_dmin=dmin)
    require(miss < 0.05, f"ugv_ex: goal within 0.05 ({miss})")
    for d, r in zip(dmin, radii):
        require(d > r - 0.05, f"ugv_ex: obstacle cleared by r - 0.05 ({d})")

    result, stats, roll = run("fleet_ex", lambda: ex["fleet_ex"].main(device=device))
    parts["fleet_ex"].update(batch=stats.n_total, success=stats.n_success,
                             rollout_success=int((roll.statuses == 0).sum()),
                             rollout_lane_steps=int(roll.statuses.numel()))
    require(bool((result.status == 0).all()), "fleet_ex: every lane SUCCESS")

    result, held, r2 = run("serving_ex", lambda: ex["serving_ex"].main(device=device))
    st3 = int(result.status[3])
    parts["serving_ex"].update(instance3=lt.ResultStatus(st3).name,
                               resumed_success=int((r2.status == 0).sum()),
                               batch=int(r2.status.numel()))
    require(st3 == lt.ResultStatus.ERROR, "serving_ex: instance 3 ERROR")
    require(np.array_equal(to_numpy(result.cmd)[3], held),
            "serving_ex: instance 3 holds its command")
    require(bool((r2.status == 0).all()), "serving_ex: the resumed fleet solves every lane")

    # (d) the port's float64 ADMM against the independent C++ oracle
    dx, status, iters, golden, admm_iters = run("oracle",
                                                lambda: oracle_quadrotor(torch, lt, device))
    parts["oracle"].update(x_vs_oracle=dx, oracle_status=status, oracle_iters=iters,
                           oracle_golden_err=golden, admm_iters=admm_iters)
    require(status == 1, "the oracle solved the quadrotor QP")
    require(dx <= 1e-5, f"float64 admm_solve within 1e-5 of the oracle ({dx})")
    require(golden <= 1e-4, f"the oracle's command within 1e-4 of the golden ({golden})")
    return parts


def phase_surface(torch, lt, card, mods):
    """The user surface on the card: (a) the quadrotor golden through
    ``libmpc_tpu_torch.compat`` in float32 and float64 (within 1e-4, status
    SUCCESS, the optimal state sequence (11, 12)); (b) the reference's
    example_nl loop through it, run to convergence (one solution a step,
    commands <= 0.5 + 1e-5); (c) the six ``examples/torch`` mains as shipped
    with each example's own checks; (d) the port's float64 ``admm_solve``
    on the quadrotor QP against the native C++ oracle (x within 1e-5, the
    oracle's command within 1e-4 of the golden).  One ``surface`` line, and
    the parts as JSON; returns the kernel launches of all parts."""
    t_phase = time.perf_counter()
    parts = surface_parts(torch, lt, mods, "cuda")
    launches = {k: sum(p["launches"][k] for p in parts.values()) for k in _wrappers(*mods)}
    print(json.dumps({"surface": parts}), flush=True)
    phase("surface", card=repr(card), parts=len(parts),
          **{f"launches_{k}": v for k, v in launches.items()},
          wall_s=f"{time.perf_counter() - t_phase:.1f}")
    for k, v in launches.items():
        require(v > 0, f"the surface path launched {k}")
    return launches


PHASES = ("k1", "k2", "k3", "k4", "k5", "k6", "lmpc", "nlmpc", "osc", "ugv", "fleet", "qp_sharded",
          "surface")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of: " + " ".join(PHASES))
    ap.add_argument("--profile", action="store_true",
                    help="with osc: a torch.profiler breakdown of the oscillator loop")
    ap.add_argument("--sweep-k3", action="store_true",
                    help="time K3 for several warps per block")
    ap.add_argument("--k3-clocks", action="store_true",
                    help="cycles of each phase of K3's register tier (an instrumented copy)")
    ap.add_argument("--k4-clocks", action="store_true",
                    help="cycles of each barrier phase of K4 (an instrumented copy)")
    ap.add_argument("--k1-clocks", action="store_true",
                    help="cycles of each phase of a staged K1 block (an instrumented copy)")
    ap.add_argument("--k2-ablate", action="store_true",
                    help="K2's register tier timed without its passes or its stores "
                         "(copies built for it)")
    ap.add_argument("--sweep-k2", action="store_true",
                    help="every other K2 layout the library has, forced and timed")
    ap.add_argument("--sweep-k1", action="store_true",
                    help="with k1: the L2 probe, K1's tiers at more batches, every staged "
                         "tile and ring depth")
    ap.add_argument("--fleet-rank", type=int, default=None,
                    help="run as this gloo rank of the fleet phase (the phase spawns them)")
    ap.add_argument("--qp-rank", type=int, default=None,
                    help="run as this gloo rank of the qp_sharded phase (the phase spawns them)")
    ap.add_argument("--qp-mesh", default="1,2", help=argparse.SUPPRESS)
    ap.add_argument("--qp-batch", type=int, default=B_QPS_SMALL, help=argparse.SUPPRESS)
    ap.add_argument("--qp-backend", default="gloo", help=argparse.SUPPRESS)
    ap.add_argument("--qp-nccl", type=int, default=0, metavar="N",
                    help="with qp_sharded: NCCL ranks on N cards, meshes (1, N) and (2, N/2), "
                         "in place of the gloo ranks sharing one card")
    ap.add_argument("--ranks-world", type=int, default=2, help=argparse.SUPPRESS)
    ap.add_argument("--ranks-init", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--ranks-out", default=None, help=argparse.SUPPRESS)
    opts = ap.parse_args(argv)
    if opts.fleet_rank is not None:
        return fleet_rank_main(opts.fleet_rank, opts.ranks_world, opts.ranks_init,
                               opts.ranks_out)
    if opts.qp_rank is not None:
        return qps_rank_main(opts.qp_rank, opts.ranks_world, opts.ranks_init,
                             opts.ranks_out, tuple(map(int, opts.qp_mesh.split(","))),
                             opts.qp_batch, opts.qp_backend)
    want = set(opts.phases.split(","))
    if not want <= set(PHASES):
        ap.error(f"unknown phase in {opts.phases!r}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    import libmpc_tpu_torch as lt
    from libmpc_tpu_torch.ops import _host as host
    from libmpc_tpu_torch.ops import admm, admm_fused, batched_linalg
    from libmpc_tpu_torch.ops import qp_inner_fused as qpf
    from libmpc_tpu_torch.ops import sqp
    from libmpc_tpu_torch.ops import trajectory_kkt as tk
    from libmpc_tpu_torch.ops import trajectory_sweeps as ts

    mods = (admm_fused, batched_linalg, qpf, ts)
    card = phase_environment(torch, admm)
    phase_build()
    if "k1" in want:
        k1_err = phase_k1(torch, admm_fused)
        k1_speed = phase_k1_speed(torch, admm_fused, card, opts.sweep_k1)
    if "k2" in want:
        k2_err = phase_k2(torch, batched_linalg)
        k2_err.update(phase_k2_nlmpc(torch, batched_linalg))
        k2b_err = phase_k2_blocked(torch, batched_linalg)
        k2_every = phase_k2_every_k(torch, batched_linalg)
        k2_speed = phase_k2_speed(torch, batched_linalg, card)
    if "k3" in want:
        k3_err = phase_k3(torch, qpf)
        k3_speed = phase_k3_speed(torch, qpf, card)
        phase_k3_caps(torch, qpf)
    if "k4" in want:
        k4_err = phase_k4(torch, ts, lt, tk)
        k4_speed = phase_k4_speed(torch, ts, card)
    if "k5" in want:
        k5_err = phase_k5(torch, ts, batched_linalg)
        k5_speed = phase_k5_speed(torch, ts, batched_linalg, card)
    if "k6" in want:
        k6_rows = phase_k6(torch, batched_linalg, card)
    if "lmpc" in want:
        launches, _ = phase_main(torch, lt, mods)
        phase_matched(torch, lt)
        phase_golden_f64(torch, lt, admm_fused, batched_linalg)
    if "nlmpc" in want:
        launches_nl = phase_main_nlmpc(torch, lt, qpf, host, mods)
        phase_matched_nlmpc(torch, lt)
        phase_golden_f64_nlmpc(torch, lt, mods)
    if "osc" in want:
        launches_osc = phase_main_osc(torch, lt, tk, sqp, qpf, host, mods)
        osc_err = phase_matched_osc(torch, lt, sqp)
    if "ugv" in want:
        launches_ugv, ugv_sum = phase_main_ugv(torch, lt, admm, batched_linalg, host, mods)
        phase_ugv_engine_f64(torch, lt, admm, batched_linalg, sqp)
        k2_ugv_err = phase_k2_ugv(torch, batched_linalg)
    if "fleet" in want:
        launches_fleet = phase_fleet(torch, lt, card, mods)
    if "qp_sharded" in want:
        launches_qps = phase_qp_sharded(torch, lt, admm, card, mods, opts.qp_nccl)
    if "surface" in want:
        launches_surface = phase_surface(torch, lt, card, mods)
    if opts.profile and "osc" in want:
        phase_profile_osc(torch, lt, host)
        phase_profile_osc_rollout(torch, lt, tk, host, mods)
    if opts.sweep_k3:
        phase_sweep_k3(torch, qpf)
    if opts.k1_clocks:
        phase_k1_clocks(torch, admm_fused)
    if opts.sweep_k2:
        phase_sweep_k2(torch, batched_linalg, card)
    if opts.k2_ablate:
        phase_k2_ablate(torch, batched_linalg, card)
    if opts.k3_clocks:
        phase_k3_clocks(torch, qpf)
    if opts.k4_clocks:
        phase_k4_clocks(torch)
    if want != set(PHASES):
        print(f"chip_smoke: ran only {sorted(want)}; no result line", flush=True)
        return 0

    paths = {"lmpc": launches, "nlmpc": launches_nl, "osc": launches_osc, "ugv": launches_ugv,
             "fleet": launches_fleet, "qp_sharded": launches_qps, "surface": launches_surface}

    # every time below is the number its kernel's speed line printed
    def entry(name, source, replaces, err, speed, **extra):
        return dict(name=name, route="cuda", source=source, replaces=replaces,
                    launches=sum(p_[name] for p_ in paths.values()), max_abs_err=err,
                    ms=speed["ms"], plain_ms=speed["plain_ms"], bound_ms=speed["bound_ms"],
                    bound_by=speed["bound_by"], library_ms=speed["library_ms"],
                    launches_by_path={k: v[name] for k, v in paths.items()}, **extra)

    def k2_device(B, k):
        row = k2_speed[(B, k, "float32")]
        return {"device_ms": row["device_ms"], "host_us_per_call": row["host_us"],
                "empty_kernel_device_ms": row["empty_ms"],
                "over_empty_us": row["over_empty_us"]}

    def k2_at(B, k):
        row = k2_speed[(B, k, "float32")]
        return {"shape": f"({B},{k},{k}),float32", "ms": row["ms"], "plain_ms": row["plain_ms"],
                "library_ms": row["library_ms"], "bound_ms": row["bound_ms"], **k2_device(B, k)}

    k2_blocked = k2_speed["blocked"]
    k2_ugv = []
    for B, k in UGV_K2_SHAPES:
        for name in ("float32", "float64"):
            row = k2_speed[(B, k, name)]
            k2_ugv.append({"shape": f"({B},{k},{k}),{name}", "ms": row["device_ms"],
                           "plain_ms": row["plain_ms"], "library_ms": row["library_ms"],
                           "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                           "max_abs_err": k2_ugv_err[(B, k, name)]})
    osc_shape = f"B={B_OSC},ph={PH_O},bs={BS_O},bs_p={BSP_O},w={W_O},float32"
    kernels = [
        entry("admm_fused", "libmpc_tpu_torch/csrc/admm_fused.cu",
              "libmpc_tpu/ops/admm_pallas.py:143", k1_err["float32"], k1_speed,
              shape=f"B={B_MAIN},n={N_QP},m={M_QP},k_iters=10,float32",
              layout=k1_layout(admm_fused, B_MAIN, torch.float32),
              launches_by_batch=launches["admm_fused_by_batch"],
              ms_float64=k1_speed["ms_float64"], ms_B1024=k1_speed["ms_B1024"]),
        entry("chol_inverse", "libmpc_tpu_torch/csrc/chol_inverse.cu",
              "libmpc_tpu/ops/batched_linalg.py:110", k2_err["float32"],
              k2_speed[(B_MAIN, 24, "float32")], shape=f"({B_MAIN},24,24),float32",
              layout=k2_layout_str(batched_linalg,
                                   batched_linalg.layout(B_MAIN, 24, torch.float32)),
              **k2_device(B_MAIN, 24), max_abs_err_every_k_float32=k2_every,
              at_nlmpc_shape=k2_at(B_NL, ME_NL),
              at_osc_shape=dict(k2_at(B_OSC, W_O), max_abs_err=k2_err["osc_float32"]),
              blocked={"shape": "({0},{1},{1}),float32".format(*K2_BLOCKED_SHAPES[0]),
                       "ms": k2_blocked["ms"], "plain_ms": k2_blocked["plain_ms"],
                       "library_ms": k2_blocked["library_ms"],
                       "bound_ms": k2_blocked["bound_ms"], "device_ms": k2_blocked["device_ms"],
                       "host_us_per_call": k2_blocked["host_us"],
                       "replaces": "libmpc_tpu/ops/batched_linalg.py:125",
                       "max_abs_err": k2b_err["float32"]},
              at_ugv_shapes=k2_ugv, launches_ugv_by_shape=ugv_sum["k2_by_shape"]),
        entry("qp_inner", "libmpc_tpu_torch/csrc/qp_inner.cu",
              "libmpc_tpu/ops/qp_inner_pallas.py:362", k3_err["float32"], k3_speed,
              shape=f"B={B_NL},n={N_NL},m={M_NL},cold,float32", tier=k3_speed["tier"],
              ms_float64=k3_speed["ms_float64"],
              refactorizations_twin=k3_speed["refactorizations_twin"]),
        entry("traj_factor", "libmpc_tpu_torch/csrc/traj_factor.cu",
              "libmpc_tpu/ops/trajectory_sweeps.py:201", k4_err["float32"], k4_speed,
              shape=osc_shape),
        entry("traj_sweep", "libmpc_tpu_torch/csrc/traj_sweep.cu",
              "libmpc_tpu/ops/trajectory_sweeps.py:337", k5_err["float32"], k5_speed,
              shape=osc_shape),
        dict(name="eig_clip", route="cuda", source="libmpc_tpu_torch/csrc/eig_clip.cu",
             replaces="none (jnp.linalg.eigh at libmpc_tpu/ops/sqp.py:458)",
             shape="(256,61,61)", launches_ugv=ugv_sum["eig_clip_launches"], **k6_rows),
    ]
    print(json.dumps({"osc_f32_cmd_err_vs_f64": {
        "mean": float(osc_err.mean()), "p99": float(np.quantile(osc_err, 0.99)),
        "max": float(osc_err.max())}}), flush=True)
    print(json.dumps({"ugv": {k: v for k, v in ugv_sum.items() if k != "k2_by_shape"}}),
          flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
