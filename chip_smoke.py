#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

Drives the port's two main paths after building the three hand-written CUDA
kernels from ``libmpc_tpu_torch/csrc`` and holding each against its plain
PyTorch twin on the card:

* the batched quadrotor LMPC control step of the reference's
  examples/quadrotor_ex.cpp through ``libmpc_tpu_torch.LMPC`` at the bench
  size (B=16384 lanes, 16 closed-loop steps);
* the batched Van der Pol NLMPC closed loop of examples/vanderpol_ex.cpp
  through ``libmpc_tpu_torch.NLMPC`` and ``nlmpc_rollout`` (B=4096 lanes, 16
  steps, float32, ``inner_qp="fused"``, ``hessian_reg="gershgorin"``).

Phases, one line each (any failure raises and the script exits non-zero):

1. environment: card, power limit, CUDA, nvcc, triton; TF32 off
2. build of the kernel library by nvcc for sm_90a
3. K1 (fused ADMM iterations) against its twin, float32 and float64
4. K2 (batched Cholesky inverse) against its twin, float32 and float64, at
   the LMPC polish's shape and at the NLMPC path's shapes
5. K3 (whole inner-QP solve) against its twin, float64 and float32, ragged
   batch included
6. LMPC main path, float32: the closed loop through K1 and K2, launch
   counts, status mix, success fraction; the unbatched float32 golden
7. LMPC matched-state accuracy against the float64 closed-loop oracle
8. LMPC float64 20-step golden trajectory on the card
9. NLMPC main path, float32: the closed loop through K3 and K2, launch
   counts, SQP and K3 iteration statistics, success fraction
10. NLMPC matched-state accuracy against the float64 Van der Pol oracle
11. NLMPC float64 20-step golden trajectory on the card (pdip and K2)
12. times: kernels, twins and library calls with CUDA events, each kernel's
    bound, steady-state and closed-loop solves/s of both paths

``--phases a,b,...`` runs a subset (names: k1 k2 k3 lmpc nlmpc times),
``--profile`` adds a ``torch.profiler`` breakdown of the NLMPC loop and
``--sweep-k3`` times K3 for several warps per block; with no arguments every
phase runs.  The second-to-last line is one JSON object
describing each kernel; the last line is ``{"ok": true, "device": {...}}``
(both only when every phase ran).

Run from the repository root:  python3 chip_smoke.py
It needs one CUDA card and the CUDA toolkit (nvcc); it imports neither JAX
nor the JAX package.  The quadrotor setup restates
``__graft_entry__.py:26-78`` and the closed-loop inputs and settings restate
``bench.py:268-300``; the Van der Pol setup, inputs and plant restate
``bench.py:437-480`` (these files import JAX, so they are not imported).
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
# settings of the fused inner-QP solver on the SQP's path (ops/sqp.py)
K3_KW = dict(sigma=1e-5, alpha=1.6, eps_abs=5e-6, eps_rel=5e-6, max_iter=300,
             check_every=25)
# published peaks of one H100 SXM: float32 outside the tensor cores, and the
# device memory rate
PEAK_FLOPS_F32 = 67e12
PEAK_BYTES = 3.35e12


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def phase(name: str, **fields) -> None:
    body = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"[{name}] {body}", flush=True)


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


def closed_loop_params(lt):
    """Production closed-loop settings (bench.py:279-300)."""
    return lt.LParameters(
        maximum_iteration=250, enable_warm_start=True, warm_start_shift=True,
        polish=True, polish_mode="shared", rho=0.01, cold_rho=0.1,
        check_termination=10,
    )


def steady_state_params(lt):
    """Warm-started steady-state re-solve settings (bench.py:82-84)."""
    return lt.LParameters(
        maximum_iteration=100, enable_warm_start=True, polish=True,
        polish_mode="shared", rho=0.01, cold_rho=0.1, check_termination=10,
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


def k1_case(torch, admm_fused, data, dtype, refine, frozen_lane=3):
    """Kernel and twin from the same nonzero state with one frozen lane.
    Returns (worst error relative to the twin's inf-norm, max abs error,
    frozen lane bitwise untouched)."""
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
    done[frozen_lane] = True
    out_k = admm_fused.fused_iterations(x, z, y, done, *args, k_iters=10, **kw)
    out_t = admm_fused.plain_iterations(x, z, y, done, *args, k_iters=10, **kw)
    torch.cuda.synchronize()
    rel, absmax = 0.0, 0.0
    for k_, t_ in zip(out_k, out_t):
        diff = (k_ - t_).abs().max().item()
        require(torch.isfinite(k_).all().item(), "K1 output finite")
        rel = max(rel, diff / max(t_.abs().max().item(), 1e-30))
        absmax = max(absmax, diff)
    frozen_ok = all(torch.equal(o[frozen_lane], s[frozen_lane])
                    for o, s in zip(out_k, (x, z, y)))
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


def phase_k1(torch, admm_fused):
    res = {}
    data = k1_problem(B_MAIN, N_QP, M_QP)
    for dtype, refine, tol in ((torch.float32, True, 1e-4),
                               (torch.float64, False, 1e-10)):
        rel, absmax, frozen = k1_case(torch, admm_fused, data, dtype, refine)
        name = str(dtype).split(".")[-1]
        phase("K1", dtype=name, B=B_MAIN, n=N_QP, m=M_QP, k_iters=10,
              refine=refine, rel_err=f"{rel:.3e}", max_abs_err=f"{absmax:.3e}",
              tol=tol, frozen_lane_bitwise=frozen)
        require(rel <= tol, f"K1 {name} within {tol} of its twin")
        require(frozen, f"K1 {name} frozen lane untouched")
        res[name] = absmax
    # ragged batches: not a multiple of the tile (8 lanes in float32, 4 in
    # float64)
    for dtype, refine, tol, B in ((torch.float32, True, 1e-4, 1003),
                                  (torch.float64, False, 1e-10, 1003)):
        data = k1_problem(B, N_QP, M_QP, seed=1)
        rel, absmax, frozen = k1_case(torch, admm_fused, data, dtype, refine)
        name = str(dtype).split(".")[-1]
        phase("K1-ragged", dtype=name, B=B,
              tile=admm_fused.pick_tile(N_QP, M_QP, dtype),
              rel_err=f"{rel:.3e}", tol=tol, frozen_lane_bitwise=frozen)
        require(rel <= tol and frozen, f"K1 ragged {name}")
    return res


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


def phase_main(torch, lt, admm_fused, batched_linalg, qpf):
    dev = "cuda"
    f32 = torch.float32
    Ad, Bd = quadrotor_model()
    Ad_t = torch.as_tensor(Ad, dtype=f32, device=dev)
    Bd_t = torch.as_tensor(Bd, dtype=f32, device=dev)
    x0_h, noise_h = closed_loop_inputs(B_MAIN, K_MAIN)
    x0 = torch.as_tensor(x0_h, dtype=f32, device=dev)
    noise = torch.as_tensor(noise_h, dtype=f32, device=dev)
    c = quadrotor_controller(lt, f32, dev, closed_loop_params(lt))

    reset_counts(admm_fused, batched_linalg, qpf)
    t0 = time.perf_counter()
    steps = run_closed_loop(torch, c, x0, noise, Ad_t, Bd_t)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"admm_fused": admm_fused.fused_iterations.launches,
                "chol_inverse": batched_linalg.chol_inverse.launches,
                "qp_inner": qpf.solve_batched.launches}

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


def k2_bound_ms(B, k):
    """Least time for K2, float32: B k^2 words in, as many out; k^3
    operations per matrix (k^3/3 for the factor, 2 k^3/3 for the inverse)."""
    return _bound(2 * B * k * k, B * k ** 3)


def phase_times(torch, lt, admm_fused, batched_linalg, card):
    dev = "cuda"
    f32 = torch.float32
    data = k1_problem(B_MAIN, N_QP, M_QP)
    t = {k: torch.as_tensor(v, dtype=f32, device=dev)
         for k, v in data.items() if k != "sigma"}
    zeros = lambda w: torch.zeros((B_MAIN, w), dtype=f32, device=dev)
    done = torch.zeros(B_MAIN, dtype=torch.bool, device=dev)
    args = (zeros(N_QP), zeros(M_QP), zeros(M_QP), done, t["q"], t["l"], t["u"],
            t["A"], t["M"], t["Minv"], t["rho"])
    kw = dict(sigma=data["sigma"], alpha=1.6, k_iters=10, refine=True)
    k1_ms = cuda_ms(torch, lambda: admm_fused.fused_iterations(*args, **kw))
    k1_plain = cuda_ms(torch, lambda: admm_fused.plain_iterations(*args, **kw))
    C = torch.as_tensor(spd_batch(B_MAIN, 24), dtype=f32, device=dev)
    k2_ms = cuda_ms(torch, lambda: batched_linalg.chol_inverse(C), reps=20)
    k2_plain = cuda_ms(torch, lambda: batched_linalg.chol_inverse_plain(C), reps=20)
    k2_lib = cuda_ms(torch, lambda: torch.linalg.inv(C), reps=20)
    k1_bound, k1_by = k1_bound_ms(B_MAIN, N_QP, M_QP, 10)
    k2_bound, k2_by = k2_bound_ms(B_MAIN, 24)
    phase("times-kernels", card=repr(card),
          K1_ms=f"{k1_ms:.4f}", K1_plain_ms=f"{k1_plain:.4f}",
          K1_bound_ms=f"{k1_bound:.4f}", K1_bound_by=k1_by,
          K1_shape=f"B={B_MAIN},n={N_QP},m={M_QP},k_iters=10,float32,refine",
          K2_ms=f"{k2_ms:.4f}", K2_plain_ms=f"{k2_plain:.4f}",
          K2_library_ms=f"{k2_lib:.4f}", K2_bound_ms=f"{k2_bound:.5f}", K2_bound_by=k2_by,
          K2_shape=f"({B_MAIN},24,24),float32")

    # steady state: warm-started re-solves of one batch (bench.py:183-229)
    rng = np.random.default_rng(0)
    x0 = torch.as_tensor(0.05 * rng.normal(size=(B_MAIN, 12)), dtype=f32, device=dev)
    c = quadrotor_controller(lt, f32, dev, steady_state_params(lt))
    r = c.optimize(x0, torch.zeros((B_MAIN, 4), dtype=f32, device=dev))
    r = c.optimize(x0, r.cmd)
    torch.cuda.synchronize()
    reps = 12
    t0 = time.perf_counter()
    for _ in range(reps):
        r = c.optimize(x0, r.cmd)
    torch.cuda.synchronize()
    ss = time.perf_counter() - t0
    ss_iters = c._last_iters.float().mean().item()

    # closed loop: 16 steps from a cold start, timed end to end
    Ad, Bd = quadrotor_model()
    x0_h, noise_h = closed_loop_inputs(B_MAIN, K_MAIN)
    cc = quadrotor_controller(lt, f32, dev, closed_loop_params(lt))
    xs = torch.as_tensor(x0_h, dtype=f32, device=dev)
    nz = torch.as_tensor(noise_h, dtype=f32, device=dev)
    Ad_t = torch.as_tensor(Ad, dtype=f32, device=dev)
    Bd_t = torch.as_tensor(Bd, dtype=f32, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_closed_loop(torch, cc, xs, nz, Ad_t, Bd_t)
    torch.cuda.synchronize()
    cl = time.perf_counter() - t0
    phase("times-e2e", card=repr(card), B=B_MAIN,
          steady_steps_per_s=f"{reps / ss:.3f}",
          steady_solves_per_s=f"{B_MAIN * reps / ss:.1f}",
          steady_step_ms=f"{1e3 * ss / reps:.2f}", steady_iters_mean=f"{ss_iters:.2f}",
          closed_loop_steps=K_MAIN, closed_loop_s=f"{cl:.3f}",
          closed_loop_solves_per_s=f"{B_MAIN * K_MAIN / cl:.1f}")
    return {"admm_fused": (k1_ms, k1_plain, k1_bound, k1_by, None),
            "chol_inverse": (k2_ms, k2_plain, k2_bound, k2_by, k2_lib)}


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
    """K2 at the shapes the NLMPC path gives it: the second-order-correction
    system (me = 20) and the interior point's barrier system (nz + 1 = 27)."""
    for B, k, dtype, tol, seed in ((B_NL, ME_NL, torch.float32, 1e-4, 3),
                                   (1024, N_NL + 1, torch.float64, 1e-10, 4)):
        C = torch.as_tensor(spd_batch(B, k, seed=seed), dtype=dtype, device="cuda")
        inv_k = batched_linalg.chol_inverse(C)
        inv_t = batched_linalg.chol_inverse_plain(C)
        torch.cuda.synchronize()
        rel = ((inv_k - inv_t).abs().max() / inv_t.abs().max()).item()
        name = str(dtype).split(".")[-1]
        phase("K2-nlmpc", dtype=name, shape=f"({B},{k},{k})", rel_err=f"{rel:.3e}", tol=tol)
        require(rel <= tol, f"K2 {name} ({B},{k},{k}) within {tol} of its twin")


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
        phase(tag, dtype="float64", B=B, n=N_NL, m=M_NL,
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


def reset_counts(admm_fused, batched_linalg, qpf):
    admm_fused.fused_iterations.launches = 0
    batched_linalg.chol_inverse.launches = 0
    qpf.solve_batched.launches = 0


def phase_main_nlmpc(torch, lt, admm_fused, batched_linalg, qpf, host):
    dev, f32 = "cuda", torch.float32
    x0_h, noise_h = vdp_closed_loop_inputs(B_NL, K_NL)
    x0 = torch.as_tensor(x0_h, dtype=f32, device=dev)
    noise = torch.as_tensor(noise_h, dtype=f32, device=dev)
    c = vdp_controller(lt, f32, dev, vdp_params(lt))

    reset_counts(admm_fused, batched_linalg, qpf)
    qpf.solve_batched.trace = []
    host.flag.reads = 0
    t0 = time.perf_counter()
    r = lt.nlmpc_rollout(c, vdp_plant(torch, noise), x0,
                         torch.zeros((B_NL, 1), dtype=f32, device=dev), K_NL)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"qp_inner": qpf.solve_batched.launches,
                "chol_inverse": batched_linalg.chol_inverse.launches,
                "admm_fused": admm_fused.fused_iterations.launches}
    reads = host.flag.reads
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
          wall_s=f"{wall:.3f}", solves_per_s=f"{B_NL * K_NL / wall:.1f}")
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


def phase_golden_f64_nlmpc(torch, lt, batched_linalg, qpf):
    """tests/test_golden_trajectories.py::test_vdp_20_step_commands on the
    card: float64, so the fused request runs the interior-point engine and
    the second-order correction goes through K2."""
    golden = np.load(ROOT / "tests" / "golden_trajectories.npz")["vdp_cmds"]
    c = vdp_controller(lt, torch.float64, "cuda", lt.NLParameters(maximum_iteration=100))
    k2, k3 = batched_linalg.chol_inverse.launches, qpf.solve_batched.launches
    x, u = np.array([0.0, 1.0]), np.zeros(1)
    worst = 0.0
    for k in range(20):
        u = c.optimize(x, u).cmd.cpu().numpy()
        worst = max(worst, float(np.abs(u - golden[k]).max()))
        x = x + 0.1 * np.array([(1.0 - x[1] ** 2) * x[0] - x[1] + u[0], x[0]])
    k2 = batched_linalg.chol_inverse.launches - k2
    k3 = qpf.solve_batched.launches - k3
    phase("golden-f64-nlmpc", steps=20, max_err=f"{worst:.3e}", tol=1e-6,
          launches_chol_inverse=k2, launches_qp_inner=k3)
    require(worst <= 1e-6, "float64 20-step Van der Pol golden within 1e-6")
    require(k2 > 0 and k3 == 0, "float64 golden ran through pdip and K2, not K3")


def k3_bound_ms(iters, n, m):
    """Least time for K3's work at these iteration counts, float32.

    Bytes: every input read once (P, A, q, l, u, rho, x0, y0, dinv, einv,
    cinv) and every output written once (x, y, z, iters, done, pri, dua).
    Operations per instance: assembling M (3 n^2 m), one Cholesky and inverse
    (n^3), per iteration two products with A, one with M and two with M^-1
    (4 m n + 6 n^2), per check Ax, A'y and Px (4 m n + 2 n^2); one
    factorization is counted (refactorizations after a rho move are not
    reported by the kernel, so the bound is a lower one)."""
    iters = np.asarray(iters, dtype=np.float64)
    B = iters.size
    words = B * (n * n + m * n + 3 * n + 5 * m + 1 + n + 2 * m + 4)
    flops = (B * (3 * n * n * m + n ** 3) + iters.sum() * (4 * m * n + 6 * n * n)
             + (iters / 25).sum() * (4 * m * n + 2 * n * n))
    return _bound(words, flops)


def phase_times_nlmpc(torch, lt, qpf, batched_linalg, card):
    dev, f32 = "cuda", torch.float32
    # K3 and its twin on the scaled problem (the kernel's own inputs), cold
    t = [torch.as_tensor(a, dtype=f32, device=dev) for a in vdp_qps(B_NL, 0)]
    x0 = torch.zeros((B_NL, N_NL), dtype=f32, device=dev)
    y0 = torch.zeros((B_NL, M_NL), dtype=f32, device=dev)
    Ps, As, qs, ls, us, xs, ys, d, e, c = qpf._scale_problem(*t[:5], x0, y0, 10)
    args = (Ps, As, qs, ls, us, t[5], xs, ys, 1.0 / d, 1.0 / e, 1.0 / c)
    kw = dict(K3_KW)
    kw.update(refine=True)
    k3_ms = cuda_ms(torch, lambda: qpf._iterate_kernel(*args, **kw), reps=10)
    k3_plain = cuda_ms(torch, lambda: qpf._iterate_plain(*args, **kw), reps=3, warmup=1)
    iters = qpf._iterate_kernel(*args, **kw)[3].cpu().numpy()
    k3_bound, k3_by = k3_bound_ms(iters, N_NL, M_NL)
    whole_ms = cuda_ms(torch, lambda: qpf.solve_batched(*t, x0, y0, **K3_KW), reps=10)
    # K2 at the path's shape, beside the one library call for the same function
    C = torch.as_tensor(spd_batch(B_NL, ME_NL, seed=3), dtype=f32, device=dev)
    k2_ms = cuda_ms(torch, lambda: batched_linalg.chol_inverse(C), reps=20)
    k2_plain = cuda_ms(torch, lambda: batched_linalg.chol_inverse_plain(C), reps=20)
    k2_lib = cuda_ms(torch, lambda: torch.linalg.inv(C), reps=20)
    phase("times-kernels-nlmpc", card=repr(card), K3_ms=f"{k3_ms:.4f}",
          K3_plain_ms=f"{k3_plain:.4f}", K3_bound_ms=f"{k3_bound:.5f}", K3_bound_by=k3_by,
          K3_iters_mean=f"{iters.mean():.1f}", K3_with_host_side_ms=f"{whole_ms:.4f}",
          K3_shape=f"B={B_NL},n={N_NL},m={M_NL},cold,float32",
          K2_ms=f"{k2_ms:.4f}", K2_plain_ms=f"{k2_plain:.4f}", K2_library_ms=f"{k2_lib:.4f}",
          K2_shape=f"({B_NL},{ME_NL},{ME_NL}),float32")

    # one optimize, cold then warm (the same state again)
    x0_h, noise_h = vdp_closed_loop_inputs(B_NL, K_NL)
    xs0 = torch.as_tensor(x0_h, dtype=f32, device=dev)
    u0 = torch.zeros((B_NL, 1), dtype=f32, device=dev)
    cc = vdp_controller(lt, f32, dev, vdp_params(lt))
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = cc.optimize(xs0, u0 if not times else r.cmd)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0, cc._last_iters.float().mean().item()))
    # closed loop, a few repeats: the steady state of a host-driven loop moves
    # between calls, so the spread is printed
    noise = torch.as_tensor(noise_h, dtype=f32, device=dev)
    rates = []
    for _ in range(3):
        cl = vdp_controller(lt, f32, dev, vdp_params(lt))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lt.nlmpc_rollout(cl, vdp_plant(torch, noise), xs0, u0, K_NL)
        torch.cuda.synchronize()
        rates.append(B_NL * K_NL / (time.perf_counter() - t0))
    phase("times-e2e-nlmpc", card=repr(card), B=B_NL,
          optimize_cold_ms=f"{1e3 * times[0][0]:.1f}", cold_sqp_iters_mean=f"{times[0][1]:.2f}",
          optimize_warm_ms="/".join(f"{1e3 * t_:.1f}" for t_, _ in times[1:]),
          warm_sqp_iters_mean="/".join(f"{i:.2f}" for _, i in times[1:]),
          closed_loop_steps=K_NL,
          closed_loop_solves_per_s="/".join(f"{r_:.1f}" for r_ in rates),
          closed_loop_median=f"{float(np.median(rates)):.1f}")
    return {"qp_inner": (k3_ms, k3_plain, k3_bound, k3_by, None),
            "k2_nlmpc": (k2_ms, k2_plain, k2_lib)}


def phase_profile_nlmpc(torch, lt, host):
    """``--profile``: device time by kernel family over four warm steps of
    the Van der Pol loop (CUDA kernel rows of ``torch.profiler`` only)."""
    from torch.profiler import ProfilerActivity, profile

    dev, f32 = "cuda", torch.float32
    x0_h, noise_h = vdp_closed_loop_inputs(B_NL, K_NL)
    x = torch.as_tensor(x0_h, dtype=f32, device=dev)
    u = torch.zeros((B_NL, 1), dtype=f32, device=dev)
    noise = torch.as_tensor(noise_h, dtype=f32, device=dev)
    plant = vdp_plant(torch, noise)
    c = vdp_controller(lt, f32, dev, vdp_params(lt))
    c.set_stats_mode("lazy")

    def steps(k0, n, x, u):
        for k in range(k0, k0 + n):
            u = c.optimize(x, u).cmd
            x = plant(x, u, k)
        return x, u

    def window(name, k0, n, x, u):
        host.flag.reads = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            x, u = steps(k0, n, x, u)
            torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
        fam = {"K3 qp_inner": 0.0, "K2 chol_inverse": 0.0, "matmul (cuBLAS)": 0.0,
               "reductions": 0.0, "elementwise and other": 0.0}
        count = 0
        for ev in prof.key_averages():
            if str(ev.device_type).endswith("CUDA"):
                ms = ev.self_device_time_total / 1e3
                count += ev.count
                key = ev.key.lower()
                if "qp_inner" in key:
                    fam["K3 qp_inner"] += ms
                elif "chol_inverse" in key:
                    fam["K2 chol_inverse"] += ms
                elif "gemm" in key or "gemv" in key or "cutlass" in key or "bmm" in key:
                    fam["matmul (cuBLAS)"] += ms
                elif "reduce" in key:
                    fam["reductions"] += ms
                else:
                    fam["elementwise and other"] += ms
        busy = sum(fam.values())
        phase(name, steps=n, wall_ms_per_step=f"{wall / n:.1f}",
              device_busy_ms_per_step=f"{busy / n:.1f}",
              idle_share=f"{max(0.0, 1 - busy / wall):.3f}",
              kernel_launches_per_step=f"{count / n:.0f}",
              host_reads_per_step=f"{host.flag.reads / n:.1f}",
              sqp_iters_mean=f"{c._last_iters.float().mean().item():.2f}",
              **{k.replace(" ", "_"): f"{v / n:.2f}ms({100 * v / max(busy, 1e-9):.1f}%)"
                 for k, v in fam.items()})
        return x, u

    x, u = window("profile-nlmpc-cold", 0, 1, x, u)
    x, u = steps(1, 3, x, u)
    window("profile-nlmpc-warm", 4, 4, x, u)
    torch.cuda.reset_peak_memory_stats()
    steps(8, 2, x, u)
    torch.cuda.synchronize()
    phase("profile-nlmpc-memory",
          peak_GiB=f"{torch.cuda.max_memory_allocated() / 2**30:.3f}")


def phase_sweep_k3(torch, qpf):
    """``--sweep-k3``: K3 alone (CUDA events) at the path's shape for several
    numbers of warps per block, twice in opposite orders within this one
    process.  The kernel gives each instance one warp; how many share a
    block decides how many instances are resident per SM and is the
    kernel's only launch parameter."""
    dev, f32 = "cuda", torch.float32
    t = [torch.as_tensor(a, dtype=f32, device=dev) for a in vdp_qps(B_NL, 0)]
    x0 = torch.zeros((B_NL, N_NL), dtype=f32, device=dev)
    y0 = torch.zeros((B_NL, M_NL), dtype=f32, device=dev)
    Ps, As, qs, ls, us, xs, ys, d, e, c = qpf._scale_problem(*t[:5], x0, y0, 10)
    args = (Ps, As, qs, ls, us, t[5], xs, ys, 1.0 / d, 1.0 / e, 1.0 / c)
    kw = dict(K3_KW, refine=True)
    per_warp = qpf.smem_bytes(N_NL, M_NL, f32)
    default, ref = qpf.WARPS_PER_BLOCK, None
    settings = (1, 2, 3, 4, 6, 8, 12)
    try:
        for order in (settings, settings[::-1]):
            for warps in order:
                qpf.WARPS_PER_BLOCK = warps
                ms = cuda_ms(torch, lambda: qpf._iterate_kernel(*args, **kw), reps=10)
                iters = qpf._iterate_kernel(*args, **kw)[3]
                ref = iters if ref is None else ref
                blocks = qpf.SMEM_LIMIT_BYTES // (warps * per_warp + 1024)
                phase("sweep-k3", warps_per_block=warps, block_smem_bytes=warps * per_warp,
                      resident_warps_per_sm=blocks * warps, ms=f"{ms:.4f}",
                      iters_equal=bool(torch.equal(iters, ref)))
    finally:
        qpf.WARPS_PER_BLOCK = default
    # the latency chain of one instance: tolerances of 0 keep every lane
    # iterating to the cap, so ms / iterations is the time of one iteration
    # of one warp, alone on the card, one per SM, and at full residency
    never = dict(kw, eps_abs=0.0, eps_rel=0.0)
    for B in (1, 132, 132 * 13):
        sub = tuple(a[:B].contiguous() for a in args)
        t300 = cuda_ms(torch, lambda: qpf._iterate_kernel(*sub, **never), reps=5)
        t25 = cuda_ms(torch, lambda: qpf._iterate_kernel(*sub, **dict(never, max_iter=25)),
                      reps=5)
        phase("latency-k3", B=B, ms_300_iters=f"{t300:.4f}", ms_25_iters=f"{t25:.4f}",
              us_per_iteration=f"{1e3 * (t300 - t25) / 275:.3f}",
              ms_setup_and_first_block=f"{t25:.4f}")


PHASES = ("k1", "k2", "k3", "lmpc", "nlmpc", "times")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of: " + " ".join(PHASES))
    ap.add_argument("--profile", action="store_true",
                    help="add a torch.profiler breakdown of the NLMPC loop")
    ap.add_argument("--sweep-k3", action="store_true",
                    help="time K3 for several warps per block")
    opts = ap.parse_args(argv)
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

    card = phase_environment(torch, admm)
    phase_build()
    if "k1" in want:
        k1_err = phase_k1(torch, admm_fused)
    if "k2" in want:
        k2_err = phase_k2(torch, batched_linalg)
        phase_k2_nlmpc(torch, batched_linalg)
    if "k3" in want:
        k3_err = phase_k3(torch, qpf)
    if "lmpc" in want:
        launches, _ = phase_main(torch, lt, admm_fused, batched_linalg, qpf)
        phase_matched(torch, lt)
        phase_golden_f64(torch, lt, admm_fused, batched_linalg)
    if "nlmpc" in want:
        launches_nl = phase_main_nlmpc(torch, lt, admm_fused, batched_linalg, qpf, host)
        phase_matched_nlmpc(torch, lt)
        phase_golden_f64_nlmpc(torch, lt, batched_linalg, qpf)
    if opts.profile:
        phase_profile_nlmpc(torch, lt, host)
    if opts.sweep_k3:
        phase_sweep_k3(torch, qpf)
    if "times" in want:
        times = phase_times(torch, lt, admm_fused, batched_linalg, card)
        times.update(phase_times_nlmpc(torch, lt, qpf, batched_linalg, card))
    if want != set(PHASES):
        print(f"chip_smoke: ran only {sorted(want)}; no result line", flush=True)
        return 0

    def entry(name, source, replaces, n_launch, err, key, **extra):
        ms, plain, bound, by, lib = times[key]
        return dict(name=name, route="cuda", source=source, replaces=replaces,
                    launches=n_launch, max_abs_err=err, ms=ms, plain_ms=plain,
                    bound_ms=bound, bound_by=by, library_ms=lib, **extra)

    k2n = times["k2_nlmpc"]
    kernels = [
        entry("admm_fused", "libmpc_tpu_torch/csrc/admm_fused.cu",
              "libmpc_tpu/ops/admm_pallas.py:143",
              launches["admm_fused"] + launches_nl["admm_fused"], k1_err["float32"],
              "admm_fused", shape=f"B={B_MAIN},n={N_QP},m={M_QP},k_iters=10,float32"),
        entry("chol_inverse", "libmpc_tpu_torch/csrc/chol_inverse.cu",
              "libmpc_tpu/ops/batched_linalg.py:110",
              launches["chol_inverse"] + launches_nl["chol_inverse"], k2_err["float32"],
              "chol_inverse", shape=f"({B_MAIN},24,24),float32",
              launches_by_path={"lmpc": launches["chol_inverse"],
                                "nlmpc": launches_nl["chol_inverse"]},
              at_nlmpc_shape={"shape": f"({B_NL},{ME_NL},{ME_NL}),float32", "ms": k2n[0],
                              "plain_ms": k2n[1], "library_ms": k2n[2],
                              "bound_ms": k2_bound_ms(B_NL, ME_NL)[0]}),
        entry("qp_inner", "libmpc_tpu_torch/csrc/qp_inner.cu",
              "libmpc_tpu/ops/qp_inner_pallas.py:362",
              launches["qp_inner"] + launches_nl["qp_inner"], k3_err["float32"],
              "qp_inner", shape=f"B={B_NL},n={N_NL},m={M_NL},cold,float32"),
    ]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
