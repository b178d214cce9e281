"""The port's layer spans and its one count of device-to-host reads
(``libmpc_tpu_torch/ops/_host.py``), on the CPU at small batches.

Without a profiler a span is a shared no-op context and no
``record_function`` is entered; under ``torch.profiler`` the spans nest as
the layers do; ``_host.reads`` counts each read of the solver paths."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import libmpc_tpu_torch as lt
from libmpc_tpu_torch.ops import _host

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the repository root's smoke script; imports no JAX)

B_LMPC, B_UGV = 256, 4


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _lmpc(params=None):
    """The quadrotor LMPC, float32, with its closed-loop settings (cold rho,
    shared polish) and B_LMPC starts: at 256 lanes the solve compacts its
    stragglers."""
    c = chip_smoke.quadrotor_controller(lt, torch.float32, "cpu",
                                        params or chip_smoke.closed_loop_params(lt))
    rng = np.random.default_rng(3)
    x0 = torch.as_tensor(0.05 * rng.normal(size=(B_LMPC, 12)), dtype=torch.float32)
    return c, x0, torch.zeros((B_LMPC, 4))


def _ugv():
    """The shipped UGV configuration (float32, ``inner_qp="admm"``) at B_UGV
    lanes, its velocity reference set for the starts."""
    c, _plant, params_fn, x0, _ = chip_smoke.ugv_setup(torch, lt, torch.float32, B_UGV,
                                                      device="cpu")
    c.set_runtime_params(params_fn(x0, 0), batched=True)
    return c, x0, torch.zeros((B_UGV, 2))


def _spans(prof):
    """{name: [(start, end), ...]} of the ``libmpc.`` spans a profile
    recorded on the host."""
    out = {}
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        if name.startswith("libmpc.") and not str(ev.device_type()).endswith("CUDA"):
            s = ev.start_ns()
            out.setdefault(name, []).append((s, s + ev.duration_ns()))
    return out


def _profiled(c, x0, u0):
    """The spans and the reads of a warm ``optimize`` (after a first one,
    which also builds the controller's time-invariant state)."""
    c.optimize(x0, u0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _host.reads = 0
        c.optimize(x0, u0)
        reads = _host.reads
    return _spans(prof), reads


def _inside(inner, outer):
    """Every interval of ``inner`` lies within one of ``outer``."""
    return all(any(s0 <= s and e <= e0 for s0, e0 in outer) for s, e in inner)


@pytest.fixture(scope="module")
def lmpc_profiled():
    c, x0, u0 = _lmpc()
    return _profiled(c, x0, u0)


@pytest.fixture(scope="module")
def ugv_profiled():
    c, x0, u0 = _ugv()
    return _profiled(c, x0, u0)


@pytest.mark.parametrize("make", [_lmpc, _ugv], ids=["lmpc", "nlmpc-admm"])
def test_no_span_is_entered_without_a_profiler(monkeypatch, make):
    def refuse(*a, **k):
        raise AssertionError("record_function entered without a profiler")

    monkeypatch.setattr(_host, "record_function", refuse)
    c, x0, u0 = make()
    r = c.optimize(x0, u0)
    assert bool(torch.isfinite(r.cmd).all())


def test_lmpc_spans_nest_as_the_layers(lmpc_profiled):
    spans, _ = lmpc_profiled
    assert set(spans) == {
        "libmpc.lmpc.optimize", "libmpc.lmpc.assemble", "libmpc.admm.solve",
        "libmpc.admm.iterate", "libmpc.admm.check", "libmpc.admm.refactor",
        "libmpc.admm.compact", "libmpc.admm.polish", "libmpc.lmpc.result"}
    assert len(spans["libmpc.lmpc.optimize"]) == 1
    assert len(spans["libmpc.admm.check"]) == len(spans["libmpc.admm.iterate"]) > 1
    assert _inside(spans["libmpc.admm.check"], spans["libmpc.admm.solve"])
    assert _inside(spans["libmpc.admm.solve"], spans["libmpc.lmpc.optimize"])
    for name in ("iterate", "refactor", "compact", "polish"):
        assert _inside(spans[f"libmpc.admm.{name}"], spans["libmpc.admm.solve"]), name
    for name in ("assemble", "result"):
        assert _inside(spans[f"libmpc.lmpc.{name}"], spans["libmpc.lmpc.optimize"]), name


def test_sqp_spans_nest_as_the_layers(ugv_profiled):
    spans, _ = ugv_profiled
    assert set(spans) >= {
        "libmpc.nlmpc.optimize", "libmpc.sqp.loop_test", "libmpc.sqp.iteration",
        "libmpc.sqp.derivatives", "libmpc.sqp.inner_qp", "libmpc.admm_each.block",
        "libmpc.admm_each.compact", "libmpc.sqp.soc", "libmpc.sqp.line_search",
        "libmpc.nlmpc.result"}
    assert not {n for n in spans if n.startswith(("libmpc.admm.", "libmpc.lmpc."))} - {
        "libmpc.admm.polish"}
    iterations = spans["libmpc.sqp.iteration"]
    assert len(spans["libmpc.sqp.loop_test"]) == len(iterations) + 1
    assert _inside(spans["libmpc.admm_each.block"], spans["libmpc.sqp.inner_qp"])
    assert _inside(spans["libmpc.sqp.inner_qp"], iterations)
    assert _inside(iterations, spans["libmpc.nlmpc.optimize"])
    for name in ("derivatives", "soc", "line_search"):
        assert _inside(spans[f"libmpc.sqp.{name}"], iterations), name
    for name in ("refactor", "compact"):
        assert _inside(spans.get(f"libmpc.admm_each.{name}", []),
                       spans["libmpc.sqp.inner_qp"]), name


def test_lmpc_reads_are_the_checks_the_factors_and_the_controllers(lmpc_profiled):
    """One read a termination check, one a KKT refactorization (the status
    of its Cholesky), one for the batch's warm flag (the cold-rho test) and
    the controller's one read of the iterations and the statuses."""
    spans, reads = lmpc_profiled
    assert reads == (len(spans["libmpc.admm.check"]) + len(spans["libmpc.admm.refactor"])
                     + 1 + 1)


def test_lmpc_reads_without_refactorizations():
    """Without the cold rho and the adaptive rho a solve reads once a check
    and once in the controller."""
    c, x0, u0 = _lmpc(lt.LParameters(maximum_iteration=250, adaptive_rho=False,
                                     check_termination=10, polish=True,
                                     polish_mode="shared"))
    spans, reads = _profiled(c, x0, u0)
    assert "libmpc.admm.refactor" not in spans
    assert reads == len(spans["libmpc.admm.check"]) + 1


def test_sqp_reads_cover_its_loops(ugv_profiled):
    """At least one read a loop test, a line search and an inner block."""
    spans, reads = ugv_profiled
    assert reads >= (len(spans["libmpc.sqp.loop_test"]) + len(spans["libmpc.sqp.line_search"])
                     + len(spans["libmpc.admm_each.block"]))
