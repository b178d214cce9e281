#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

Drives the port's main path — the batched quadrotor LMPC control step of the
reference's examples/quadrotor_ex.cpp — through ``libmpc_tpu_torch.LMPC`` at
the bench size (B=16384 lanes, 16 closed-loop steps), after building the two
hand-written CUDA kernels from ``libmpc_tpu_torch/csrc`` and holding each
against its plain PyTorch twin on the card.  Phases, one line each (any
failure raises and the script exits non-zero):

1. environment: card, power limit, CUDA, nvcc, triton; TF32 off
2. build of the kernel library by nvcc for sm_90a
3. K1 (fused ADMM iterations) against its twin, float32 and float64
4. K2 (batched Cholesky inverse) against its twin, float32 and float64
5. main path, float32: the closed loop through both kernels, launch counts,
   status mix, success fraction; the unbatched float32 golden command
6. matched-state accuracy against the float64 closed-loop oracle
7. float64 20-step golden trajectory on the card
8. times: kernels and twins with CUDA events, steady-state and closed-loop
   solves/s

The second-to-last line is one JSON object describing each kernel; the last
line is ``{"ok": true, "device": {...}}``.

Run from the repository root:  python3 chip_smoke.py
It needs one CUDA card and the CUDA toolkit (nvcc); it imports neither JAX
nor the JAX package.  The quadrotor setup restates
``__graft_entry__.py:26-78`` and the closed-loop inputs and settings restate
``bench.py:268-300`` (both files import JAX, so they are not imported).
"""

from __future__ import annotations

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


def phase_main(torch, lt, admm_fused, batched_linalg, admm):
    dev = "cuda"
    f32 = torch.float32
    Ad, Bd = quadrotor_model()
    Ad_t = torch.as_tensor(Ad, dtype=f32, device=dev)
    Bd_t = torch.as_tensor(Bd, dtype=f32, device=dev)
    x0_h, noise_h = closed_loop_inputs(B_MAIN, K_MAIN)
    x0 = torch.as_tensor(x0_h, dtype=f32, device=dev)
    noise = torch.as_tensor(noise_h, dtype=f32, device=dev)
    c = quadrotor_controller(lt, f32, dev, closed_loop_params(lt))

    admm_fused.fused_iterations.launches = 0
    batched_linalg.chol_inverse.launches = 0
    t0 = time.perf_counter()
    steps = run_closed_loop(torch, c, x0, noise, Ad_t, Bd_t)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"admm_fused": admm_fused.fused_iterations.launches,
                "chol_inverse": batched_linalg.chol_inverse.launches}

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
    phase("times-kernels", card=repr(card),
          K1_ms=f"{k1_ms:.4f}", K1_plain_ms=f"{k1_plain:.4f}",
          K1_shape=f"B={B_MAIN},n={N_QP},m={M_QP},k_iters=10,float32,refine",
          K2_ms=f"{k2_ms:.4f}", K2_plain_ms=f"{k2_plain:.4f}",
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
    return {"admm_fused": (k1_ms, k1_plain), "chol_inverse": (k2_ms, k2_plain)}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    import libmpc_tpu_torch as lt
    from libmpc_tpu_torch.ops import admm, admm_fused, batched_linalg

    card = phase_environment(torch, admm)
    phase_build()
    k1_err = phase_k1(torch, admm_fused)
    k2_err = phase_k2(torch, batched_linalg)
    launches, _ = phase_main(torch, lt, admm_fused, batched_linalg, admm)
    phase_matched(torch, lt)
    phase_golden_f64(torch, lt, admm_fused, batched_linalg)
    times = phase_times(torch, lt, admm_fused, batched_linalg, card)

    kernels = [
        {"name": "admm_fused", "route": "cuda",
         "source": "libmpc_tpu_torch/csrc/admm_fused.cu",
         "replaces": "libmpc_tpu/ops/admm_pallas.py:143",
         "launches": launches["admm_fused"], "max_abs_err": k1_err["float32"],
         "ms": times["admm_fused"][0], "plain_ms": times["admm_fused"][1]},
        {"name": "chol_inverse", "route": "cuda",
         "source": "libmpc_tpu_torch/csrc/chol_inverse.cu",
         "replaces": "libmpc_tpu/ops/batched_linalg.py:110",
         "launches": launches["chol_inverse"], "max_abs_err": k2_err["float32"],
         "ms": times["chol_inverse"][0], "plain_ms": times["chol_inverse"][1]},
    ]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
