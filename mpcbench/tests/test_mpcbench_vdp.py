"""The Van der Pol cell, ``vanderpol-nlmpc.b4096``, at a size a test holds.

On the CPU: in float64 the program's commands are the reference's, and each
fault of :mod:`mpcbench.faults` planted in the timed path comes out not
correct.  The cell compares a median and a quartile only (the program's
widest gaps are no tighter than its control's, ``PERF.md``), so one altered
command among many lanes is not a fault it can catch: the altered fault runs
on a batch of one, where every command is the altered one.  On the card (they
skip without one): the program is correct and its control is not.

    python -m pytest -q -p no:cacheprovider mpcbench/tests/test_mpcbench_vdp.py
"""

from __future__ import annotations

import types

import pytest
import torch

from mpcbench import check, control, faults, generator, loop, run, trace

CELL = "vanderpol-nlmpc.b4096"


def test_reference_agrees_with_the_float64_program():
    cell = run.Cell(CELL)
    cell.traffic.update(batch=4, warmup_steps=1, episode_steps=3,
                        profile_steps=min(2, cell.traffic["profile_steps"]))
    cell.cfg["dtype"] = "float64"
    res, checks = run.measure(cell, 2 ** 31 + 11, 0.1, False, device="cpu")
    assert checks["compared"][0] > 0 and checks["cmd_gap_median"][0] < 1e-6
    assert checks["cmd_gap_max"][0] < 1e-6 and res["correct"] is True


@pytest.mark.parametrize("fault,batch", [("none", 4), ("stale", 4), ("half", 4),
                                         ("altered", 1)])
def test_a_broken_timed_path_is_not_correct(fault, batch):
    cell = run.Cell(CELL)
    cell.traffic.update(batch=batch, warmup_steps=1, episode_steps=4,
                        check_lanes_per_step=4 * batch)
    res, checks = run.measure(cell, 2 ** 31 + 101, 2.0, False, device="cpu",
                              hook=faults.FAULTS.get(fault))
    assert res["correct"] is (fault == "none"), checks
    assert torch.isfinite(torch.tensor(checks["cmd_gap_median"][0]))


def test_a_lane_newton_does_not_solve_reads_an_infinite_gap():
    cell = run.Cell(CELL)
    x = torch.tensor([[0.3, -0.2], [0.3, -0.2]], dtype=torch.float64)
    plan = torch.zeros((2, cell.cfg["ph"] + 1, 2), dtype=torch.float64)
    plan[:, 0] = x
    plan_u = torch.zeros((2, cell.cfg["ph"] + 1, 1), dtype=torch.float64)
    plan[1, 3, 0] = float("nan")  # lane 1's plan: no Newton step from it is finite
    samples = {"x": x, "plan": plan, "plan_u": plan_u, "cmd": torch.zeros((2, 1)),
               "status": torch.zeros(2, dtype=torch.int64)}
    ref = cell.builder.answers(cell.cfg, samples, "cpu")
    g, unsolved = check.gaps(samples, ref, "cpu")
    assert unsolved == 0 and g.numel() == 2
    assert torch.isfinite(g[0]) and g[1] == float("inf")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels have no CPU mode)")
    return "cuda"


@pytest.mark.cuda
def test_control_is_not_correct(cuda):
    cell = run.Cell(CELL)
    cell.traffic.update(batch=256)
    system = cell.builder.build(cell.cfg, cell.traffic, cuda)
    loop.warm_up(system, cell.traffic, 1)
    limits = cell.cfg["check"]["limits"]
    as_checks = lambda r: dict({k: (r[k], lim) for k, lim in limits.items()},
                               compared=(r["compared"], None))
    for seed in (2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3):
        eps = generator.Episodes(cell.traffic, system.nx, system.nu, seed, 0, system.dtype,
                                 cuda)
        lanes = generator.sample_lanes(cell.traffic, seed, 4096, cuda)
        w = loop.run_window(system, loop.Loop(system, eps), lanes, 3.0, False)
        samples = {k: torch.cat([s[k] for s in w.samples]) for k in w.samples[0]}
        program = control.readings(cell.builder, cell.cfg, samples, cuda, system.success)
        ctrl = control.control_samples(cell.builder, cell.cfg, samples, cuda, system.success)
        reading = control.readings(cell.builder, cell.cfg, ctrl, cuda, system.success)
        assert reading["compared"] >= 0.9 * program["compared"], reading  # it converged
        assert check.verdict(as_checks(program)), program
        assert not check.verdict(as_checks(reading)), reading


# -- the readers of the fused engine's spans and counter ---------------------
def _reader(name):
    return run.load_module(run.HERE / "metrics" / f"{name}.py", f"t_vdp_{name}")


def test_fused_idle_share_is_a_part_of_the_inner_share():
    idle_fused, idle_inner = _reader("idle_fused_pct"), _reader("idle_inner_pct")
    host = [("libmpc.sqp.iteration", 0, 1000), ("libmpc.sqp.inner_qp", 100, 700),
            ("libmpc.qp_fused.scale", 110, 300), ("libmpc.qp_fused.iterate", 300, 450),
            ("libmpc.qp_fused.unscale", 450, 600)]
    device = [("void qp_inner_reg_kernel<float>", 320, 440), ("k", 150, 200)]
    p = trace.Profile(window=(0, 1000), device=device, host=host, steps=1)
    r = types.SimpleNamespace(profile=p)
    # idle under the fused spans: [110, 150], [200, 320], [440, 600]
    assert idle_fused.read(r) == pytest.approx(100 * (40 + 120 + 160) / 1000)
    assert idle_fused.read(r) <= idle_inner.read(r)
    r.profile = trace.Profile(window=(0, 1000), device=device, host=host[:2], steps=1)
    assert idle_fused.read(r) is None  # a program without the spans


def test_k3_roofline_reads_the_profiled_kernel_rows():
    from libmpc_tpu_torch.ops import qp_inner_fused

    roof = _reader("k3_roofline_pct")
    cell = run.Cell(CELL)
    device = [("void qp_inner_reg_kernel<float>", 0, 500_000),
              ("void qp_inner_reg_kernel<float>", 600_000, 900_000), ("gemm", 0, 10)]
    r = types.SimpleNamespace(shared={}, cfg=cell.cfg, notes={}, power_limit="test",
                              profile=trace.Profile(window=(0, 10 ** 6), device=device,
                                                    host=[], steps=2))
    prev = qp_inner_fused.solve_batched.trace
    try:
        roof.open(r)
        roof.close(r)
        it = torch.full((4096,), 50, dtype=torch.int32)
        qp_inner_fused.solve_batched.trace.append((it, torch.ones(4096, dtype=torch.bool)))
        least, by = roof.least_seconds([50] * 4096, 26, 57)
        assert roof.read(r) == pytest.approx(100 * least / 8e-4)
        assert by == "operations" and "bound by operations" in r.notes["k3_roofline_pct"]
        assert qp_inner_fused.solve_batched.trace is None
    finally:
        qp_inner_fused.solve_batched.trace = prev
