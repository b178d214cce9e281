"""The Van der Pol NLMPC of the benchmark (``mpcbench/configs/vanderpol-nlmpc``)
on the CPU: the port against the plain reference ``mpcbench/reference/
vdp_nlp.py``, the fused engine's spans, and the arithmetic of the K3 metrics.

The port's controller is the one the benchmark's configuration module builds
(the example's model, cost, inequality and fleet settings); in float64 a
``"fused"`` request runs the interior point, in float32 the fused engine
through K3's plain twin.  No JAX.
"""

import copy
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from mpcbench import run  # noqa: E402  (the repository's benchmark; imports no JAX)
from mpcbench.reference import vdp_nlp  # noqa: E402

from libmpc_tpu_torch.ops import qp_inner_fused, sqp  # noqa: E402

CFG = json.loads((ROOT / "mpcbench" / "configs" / "vanderpol-nlmpc.json").read_text())
BUILDER = run.load_module(ROOT / "mpcbench" / "configs" / "vanderpol-nlmpc.py", "vdp_builder")
FUSED_SPANS = ("libmpc.qp_fused.scale", "libmpc.qp_fused.iterate", "libmpc.qp_fused.unscale")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _system(dtype, batch):
    cfg = dict(CFG, dtype=dtype)
    return cfg, BUILDER.build(cfg, {"batch": batch}, "cpu")


def _starts(seed, batch):
    """Starts as the JAX package's record draws them, U(-1, 1)."""
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.uniform(-1.0, 1.0, size=(batch, 2)))


def _closed_loop_gaps(dtype, seed, steps=3, batch=4):
    """Per lane-step command gaps against the reference, over ``steps``
    closed-loop steps of the configuration's plant, on the lanes the port solved."""
    cfg, system = _system(dtype, batch)
    x = _starts(seed, batch).to(system.dtype)
    u = torch.zeros((batch, 1), dtype=system.dtype)
    gaps = []
    for _ in range(steps):
        r = system.controller.optimize(x, u)
        kept = system.keep(torch.arange(batch), x, u, r)
        ref = BUILDER.answers(cfg, kept, "cpu")
        ok = (kept["status"] == system.success) & ref["converged"]
        gaps.append((kept["cmd"].double() - ref["cmd"]).abs().amax(dim=1)[ok])
        x, u = system.plant(x, r.cmd, None), r.cmd
    return torch.cat(gaps)


@pytest.mark.parametrize("seed", [11, 12, 13, 14])
def test_float64_port_gives_the_reference_commands(seed):
    g = _closed_loop_gaps("float64", seed)
    assert g.numel() >= 6  # most lane-steps solved and compared
    assert float(g.max()) < 1e-6


def test_float32_fused_route_within_the_cells_limit():
    _, system = _system("float32", 4)
    assert sqp.inner_engine(system.controller._params, torch.float32, CFG["qp_n"],
                            CFG["qp_m"]) == "fused"
    g = torch.cat([_closed_loop_gaps("float32", seed) for seed in (11, 12)])
    assert g.numel() >= 12
    assert float(torch.quantile(g, 0.5)) <= CFG["check"]["limits"]["cmd_gap_median"]


def test_reference_at_the_origin_and_at_the_cap():
    f64 = torch.float64
    ref = vdp_nlp.VanDerPolMPC(CFG, "cpu")
    free = vdp_nlp.VanDerPolMPC(dict(CFG, u_max=1e9), "cpu")
    x0 = torch.tensor([[0.0, 0.0], [-1.0, 0.0], [1.0, 0.0]], dtype=f64)
    X = x0[:, None, :].expand(3, CFG["ph"] + 1, 2).clone()
    U = torch.zeros((3, CFG["ph"] + 1, 1), dtype=f64)
    u, _, Ur, conv = ref.solve(x0, X, U)
    u_free, _, _, conv_free = free.solve(x0, X, U)
    assert conv.all() and conv_free.all()
    assert float(u[0].abs().max()) == 0.0  # the origin is the zero command
    # from (-1, 0) the unconstrained first move is above 0.5: the cap holds
    assert float(u_free[1, 0]) > 0.5 + 0.1
    assert float(u[1, 0]) == pytest.approx(0.5, abs=1e-12)
    assert float(Ur[1].max()) <= 0.5 + 1e-12
    # the oscillator is odd: f(-x, -u) = -f(x, u); without the cap so is the answer
    assert float(u_free[2, 0]) == pytest.approx(-float(u_free[1, 0]), abs=1e-10)


def _spans(prof):
    out = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.name().startswith("libmpc."):
            s = ev.start_ns()
            out.setdefault(ev.name(), []).append((s, s + ev.duration_ns()))
    return out


def test_fused_spans_nest_in_the_inner_qp_and_change_nothing():
    x0 = _starts(5, 4).float()
    u0 = torch.zeros((4, 1))
    plain = _system("float32", 4)[1].controller
    r0 = plain.optimize(x0, u0)
    traced = _system("float32", 4)[1].controller
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        r1 = traced.optimize(x0, u0)
    assert torch.equal(r0.cmd, r1.cmd) and torch.equal(r0.status, r1.status)
    assert torch.equal(plain._last_iters, traced._last_iters)
    spans = _spans(prof)
    inner = spans["libmpc.sqp.inner_qp"]
    for name in FUSED_SPANS:
        assert len(spans[name]) == len(inner), name
        assert all(any(s0 <= s and e <= e0 for s0, e0 in inner) for s, e in spans[name])


def _reader(name):
    return run.load_module(ROOT / "mpcbench" / "metrics" / f"{name}.py", f"vdp_{name}")


def test_k3_roofline_count():
    k3 = _reader("k3_roofline_pct")
    n, m = 26, 57
    iters = [25] * 3000 + [50] * 1000 + [300] * 96
    least, by = k3.least_seconds(iters, n, m)
    solves = 4096
    ops = (25 * 3000 + 50 * 1000 + 300 * 96) * (4 * m * n + 6 * n * n) + solves * (
        2 * n * n * m + m * n + n ** 3)
    nbytes = solves * 4 * (n * n + m * n + 3 * n + 6 * m)
    assert ops == 153_800 * 9_984 + 4_096 * 96_122
    assert nbytes == 4_096 * 10_312
    assert by == "operations"
    assert least == pytest.approx(max(ops / 67e12, nbytes / 3.35e12))
    # with no iteration at all the reads and writes bound the solve
    assert k3.least_seconds([0] * 10, n, m)[1] == "bytes"


def test_k3_counters_on_a_synthetic_trace():
    means, caps = _reader("k3_iters_mean"), _reader("k3_at_cap_pct")
    roof = _reader("k3_roofline_pct")
    r = type("Run", (), {})()
    r.shared, r.cfg, r.profile = {}, copy.deepcopy(CFG), None
    prev = qp_inner_fused.solve_batched.trace
    try:
        means.open(r)
        caps.open(r)
        assert qp_inner_fused.solve_batched.trace is r.shared["k3_trace"]
        t = qp_inner_fused.solve_batched.trace
        done = lambda k: torch.ones(k, dtype=torch.bool)
        t.append((torch.tensor([25, 50, 300, 25], dtype=torch.int32), done(4)))
        t.append((torch.tensor([300, 75], dtype=torch.int32), done(2)))
        s1, s2 = means.close(r), caps.close(r)
        assert s1 is s2
        assert means.read(r, s1) == pytest.approx(775 / 6)
        assert caps.read(r, s2) == pytest.approx(100 * 2 / 6)
        # the counter is armed again, with a list of its own, for the profile
        armed = qp_inner_fused.solve_batched.trace
        assert armed == [] and armed is not t
        assert roof.read(r) is None  # no profile: nothing to read, nothing raised
        assert qp_inner_fused.solve_batched.trace is None
    finally:
        qp_inner_fused.solve_batched.trace = prev
