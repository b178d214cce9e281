"""CPU tests of the benchmark's harness: the files of every cell, the
traffic, the metric arithmetic, the reference, the last line and the
import check.

    python -m pytest -q -p no:cacheprovider mpcbench/tests

(the repository's tier-1 run collects ``tests/`` only).  Runs on the CPU
use tiny batches and short windows; nothing here times anything.
"""

from __future__ import annotations

import json
import math
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from mpcbench import check, generator, run, stats, trace
from mpcbench.reference import lmpc_qp, qp_ipm, ugv_nlp

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def tiny(cell: run.Cell, batch: int, episode: int = 4) -> run.Cell:
    """The cell at a size a CPU test holds."""
    cell.traffic.update(batch=batch, warmup_steps=1, episode_steps=episode,
                        profile_steps=min(2, cell.traffic["profile_steps"]))
    return cell


# -- BENCHMARK.json and the files it names -------------------------------------
def test_benchmark_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [c["name"] for c in BENCH["configs"]] + CELLS + [
        m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(n), n
    assert {m["name"] for m in BENCH["end_to_end"]} >= {"setup_s"}
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
    # every cell reports set-up, another end-to-end metric and a per-layer one
    for w in CELLS:
        cell = run.Cell(w)
        assert {m["name"] for m in cell.end_to_end} > {"setup_s"} and cell.per_layer
    for w in BENCH["workloads"]:
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200


def test_run_seconds_fits_the_check():
    R = BENCH["run_seconds"]
    assert 1 <= R <= 51
    assert (2 + 14 * 24) * (R + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_loads_by_name(name):
    cell = run.Cell(name)
    assert callable(cell.builder.build) and callable(cell.builder.answers)
    for key in ("batch", "episode_steps", "start_std", "warmup_steps",
                "check_lanes_per_step", "profile_steps"):
        assert key in cell.traffic
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2 and cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(cell.reader(m).read)
    assert cell.cfg["reduced"] == [] and cell.cfg["check"]["limits"]


# -- traffic ------------------------------------------------------------------
@pytest.mark.parametrize("name", CELLS)
def test_traffic_repeats_from_one_seed(name):
    cell = run.Cell(name)
    cell.traffic["batch"] = 32
    nx = len(cell.cfg.get("Ad", cell.cfg.get("A")))
    nu = cell.cfg["nu"]

    def draw(seed):
        e = generator.Episodes(cell.traffic, nx, nu, seed, 0, torch.float32, "cpu")
        x, u = e.start()
        n = e.noise()
        return x, u, n, generator.sample_lanes(cell.traffic, seed, 16, "cpu")

    big = 2 ** 31 + 977
    a, b, c = draw(big), draw(big), draw(big + 1)
    for p, q in zip(a, b):
        assert p is None and q is None or torch.equal(p, q)
    assert not torch.equal(a[0], c[0])
    # every seed runs the same set of starts, in another order
    rows = lambda x: sorted(map(tuple, x.tolist()))
    assert rows(a[0]) == rows(c[0])
    assert a[0].shape == (32, nx) and torch.all(a[1] == 0)


def test_derived_seeds_differ_by_stream():
    s = 2 ** 31 + 5
    assert len({generator.derived_seed(s, k) for k in range(3)}) == 3
    assert all(0 <= generator.derived_seed(s, k) < 2 ** 63 for k in range(3))


# -- metric arithmetic --------------------------------------------------------
def test_percentile_rate_and_spread():
    vals = list(range(1, 101))
    assert stats.percentile(vals, 95) == pytest.approx(95.05)
    assert stats.percentile([3.0], 95) == 3.0
    assert stats.rate(16384 * 600, 40.0) == 245760.0
    q1, med, q3 = statistics.quantiles([1, 2, 3, 4, 5, 6], n=4)
    assert stats.spread([1, 2, 3, 4, 5, 6]) == pytest.approx((q3 - q1) / med)


def test_k1_roofline_count():
    k1 = run.load_module(ROOT / "mpcbench" / "metrics" / "k1_roofline_pct.py", "k1")
    n, m = 216, 535
    steps = [[10] * 1000 + [20] * 1000, [5] * 1000]
    least, by = k1.least_seconds(steps, n, m, 10)
    ops = 35000 * (4 * m * n + 6 * n * n)
    blocks = 1000 * (1 + 2 + 1)
    nbytes = 4 * (3 * n + 6 * m + 1) * blocks + 4 * (m * n + 2 * n * n + m) * (2 + 1)
    assert by == "operations"
    assert least == pytest.approx(max(ops / 67e12, nbytes / 3.35e12))
    # three lanes read the shared matrices more than their own work needs
    assert k1.least_seconds([[10, 20], [5]], n, m, 10)[1] == "bytes"


def test_trace_union_idle_and_families():
    p = trace.Profile(
        window=(0, 1000),
        device=[("void admm_stream_kernel<float>", 100, 300), ("gemm_kernel", 250, 400),
                ("Memcpy HtoD", 600, 700), ("elementwise", 950, 1100)],
        host=[("optimize", 0, 800), ("aten::mm", 400, 650), ("plant", 800, 1000)],
        steps=2)
    assert p.union().tolist() == [[100, 400], [600, 700], [950, 1000]]
    assert p.busy_s() == pytest.approx(450e-9)
    assert p.kernels() == 3
    fam = p.seconds_by(trace.family)
    assert fam["K1 admm_fused"] == pytest.approx(200e-9)
    assert fam["cuBLAS"] == pytest.approx(150e-9)
    gaps = p.idle_gaps()
    assert gaps["optimize: python"] == pytest.approx(100e-9)
    assert gaps["optimize: aten::mm"] == pytest.approx(200e-9)
    assert gaps["plant: python"] == pytest.approx(250e-9)
    assert sum(gaps.values()) == pytest.approx(1e-6 - p.busy_s())


def test_check_verdict():
    ok = {"cmd_gap_max": (1e-5, 1e-3), "compared": (10, None)}
    assert check.verdict(ok)
    assert not check.verdict(dict(ok, cmd_gap_max=(2e-3, 1e-3)))
    assert not check.verdict(dict(ok, cmd_gap_max=(float("nan"), 1e-3)))
    assert not check.verdict(dict(ok, compared=(0, None)))


def test_check_statistics():
    g = torch.tensor([4.0, 1.0, 3.0, 2.0, float("nan")], dtype=torch.float64)
    r = check.readings(g[:4], "dynamics_gap")
    assert r == {"dynamics_gap_max": 4.0, "dynamics_gap_median": 2.5,
                 "dynamics_gap_p75": 3.25}
    assert check.readings(g)["cmd_gap_max"] == float("inf")  # NaN is a gap of its own
    assert set(check.readings(g[:0]).values()) == {float("inf")}


# -- the reference --------------------------------------------------------------
def test_ipm_on_a_known_qp():
    # min 1/2 |u|^2 - [1, 1]'u  s.t.  u0 + u1 <= 1, -u0 <= 0  ->  u = (0.5, 0.5)
    H = torch.eye(2, dtype=torch.float64)
    g = torch.tensor([[-1.0, -1.0], [-1.0, 3.0]], dtype=torch.float64)
    G = torch.tensor([[1.0, 1.0], [-1.0, 0.0]], dtype=torch.float64)
    h = torch.tensor([[1.0, 0.0], [1.0, 0.0]], dtype=torch.float64)
    u, conv = qp_ipm.solve(H, g, G, h)
    assert conv.all()
    # the second lane's free optimum (1, -3) meets both rows
    assert torch.allclose(u[0], torch.tensor([0.5, 0.5], dtype=torch.float64), atol=1e-8)
    assert torch.allclose(u[1], torch.tensor([1.0, -3.0], dtype=torch.float64), atol=1e-8)
    u32, conv32 = qp_ipm.solve(H.float(), g.float(), G.float(), h.float())
    assert conv32.all() and torch.allclose(u32.double(), u, atol=1e-4)


def test_ipm_floor_by_precision():
    assert qp_ipm.floor(torch.float64) == 1e-9
    assert qp_ipm.floor(torch.float32) == 32 * 2.0 ** -24
    assert qp_ipm.floor(torch.float32, tf32=True) == 32 * 2.0 ** -11


def test_lmpc_reference_gives_the_quadrotor_golden():
    """libmpc++'s own quadrotor test: the command at x0 = 0, u = 0 is
    [-0.9916, 1.74839, -0.9916, 1.74839] to its 1e-4."""
    cfg = run.Cell("quadrotor-lmpc.b16384").cfg
    ref = lmpc_qp.LinearMPC(cfg, "cpu")
    cmd, conv = ref.commands(torch.zeros((1, 12), dtype=torch.float64),
                             torch.zeros((1, 4), dtype=torch.float64))
    assert conv.all()
    golden = torch.tensor([-0.9916, 1.74839, -0.9916, 1.74839], dtype=torch.float64)
    assert (cmd[0] - golden).abs().max() < 1e-4


def test_ugv_reference_model_and_free_optimum():
    cfg = run.Cell("ugv-nlmpc.b256").cfg
    f64 = torch.float64
    Ad, Bd = ugv_nlp.zoh(torch.tensor(cfg["A"], dtype=f64), torch.tensor(cfg["B"], dtype=f64),
                         0.1)
    I2 = torch.eye(2, dtype=f64)
    assert torch.allclose(Ad, torch.block_diag(I2, I2) + torch.cat(
        [torch.cat([0 * I2, 0.1 * I2], 1), torch.zeros(2, 4, dtype=f64)]), atol=1e-15)
    assert torch.allclose(Bd, torch.cat([0.005 * I2, 0.1 * I2]), atol=1e-15)
    ref = ugv_nlp.ObstacleMPC(cfg, "cpu")
    # far from both obstacles every tangent row is slack: the free optimum
    x0 = torch.tensor([[-3.0, 3.0, 0.0, 0.0]], dtype=f64)
    far = x0[:, None, 0:2].expand(1, 11, 2)
    u, X, conv = ref.solve(x0, far)
    d = torch.tensor([2.0, 2.0], dtype=f64) - x0[0, 0:2]
    v_ref = d / d.norm()
    err = ref.Phi[:, 2:4] @ x0[0] - v_ref
    g = ref.wv * torch.einsum("kin,ki->n", ref.Gam[:, 2:4], err)
    free = torch.linalg.solve(ref.H, -g)
    assert conv.all() and torch.allclose(u[0], free[:2], atol=1e-7)
    assert torch.allclose(X[0, 1], Ad @ x0[0] + Bd @ free[:2], atol=1e-9)


@pytest.mark.parametrize("name,batch", [("quadrotor-lmpc.b16384", 8), ("ugv-nlmpc.b256", 3)])
def test_reference_agrees_with_the_float64_program(name, batch):
    """On the CPU, in float64, the program's commands are the reference's."""
    cell = tiny(run.Cell(name), batch, episode=3)
    cell.cfg["dtype"] = "float64"
    res, checks = run.measure(cell, 2 ** 31 + 11, 0.1, False, device="cpu")
    g = checks["cmd_gap_median"][0]
    assert checks["compared"][0] > 0 and g < 1e-6


# -- a run's last line and where it runs ----------------------------------------
def test_last_line_shape():
    cell = tiny(run.Cell("quadrotor-lmpc.b16384"), 8)
    torch.backends.cuda.matmul.allow_tf32 = True
    res, checks = run.measure(cell, 2 ** 31 + 3, 0.5, True, device="cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is cell.cfg["tf32"] is False
    line = json.loads(json.dumps(res))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] % 8 == 0 and line["attempted"] > 0
    assert {"admm_iters_mean", "device_idle_pct.lmpc", "kernels_per_step.lmpc"} <= set(
        line["metrics"])
    for v in line["metrics"].values():
        assert set(v) == {"value", "unit"} and math.isfinite(v["value"])
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes",
                                   "busy_s", "window_s"}
    assert len(line["breakdown"]["idle_gaps"]) <= 10
    assert line["device"]["count"] == 1
    assert all(c["limit"] is None or c["value"] <= c["limit"] for c in line["checks"].values())


@pytest.mark.parametrize("name", CELLS)
def test_a_configuration_may_bring_its_own_runner(name):
    cell = run.Cell(name)
    assert run.runner(cell) is run.measure
    own = lambda cell, seed, seconds, trace, parts=None: ({"device": {"count": 4}}, {})
    cell.builder = type("Builder", (), {"run": staticmethod(own)})
    assert run.runner(cell) is own


def _python(code: str, cwd: Path):
    env = {"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "", "HOME": str(cwd)}
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, capture_output=True,
                          text=True, timeout=600, env=env)


def test_a_run_without_a_card_prints_no_result():
    p = subprocess.run([sys.executable, "-m", "mpcbench.run", "--workload",
                        "quadrotor-lmpc.b16384", "--seed", str(2 ** 31 + 1), "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=300,
                       env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0 and p.stdout == ""


def test_the_benchmark_alone_prints_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "mpcbench", tmp_path / "mpcbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _python("from mpcbench import run\n"
                "cell = run.Cell('quadrotor-lmpc.b16384'); cell.traffic['batch'] = 4\n"
                "print(run.measure(cell, 1, 0.1, False, device='cpu'))", tmp_path)
    assert p.returncode != 0 and p.stdout == ""
    assert "libmpc_tpu_torch" in p.stderr


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = ("import sys\n"
            "from mpcbench import run\n"
            "cell = run.Cell('quadrotor-lmpc.b16384')\n"
            "cell.traffic.update(batch=4, warmup_steps=1, episode_steps=3)\n"
            "run.measure(cell, 7, 0.2, False, device='cpu')\n"
            "bad = run.forbidden_modules()\n"
            "assert 'libmpc_tpu_torch' in sys.modules\n"
            "print('FORBIDDEN', bad)\n")
    p = _python(code, ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    assert "FORBIDDEN []" in p.stdout
    assert run.FORBIDDEN == ("jax", "jaxlib", "flax", "libmpc_tpu")
    names = ["libmpc_tpu_torch", "libmpc_tpu_torch.ops", "jax_like", "libmpc_tpu.x"]
    assert [n for n in names if n.split(".")[0] in run.FORBIDDEN] == ["libmpc_tpu.x"]
