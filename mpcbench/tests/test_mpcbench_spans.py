"""CPU tests of the readers of the program's spans and read count:
``idle_admm_pct``, ``idle_sqp_pct``, ``idle_inner_pct`` and
``host_reads_per_step``, on synthetic profiles and windows.

    python -m pytest -q -p no:cacheprovider mpcbench/tests/test_mpcbench_spans.py
"""

from __future__ import annotations

import types

import numpy as np
import pytest

from mpcbench import run, trace

METRICS = run.HERE / "metrics"
idle_admm = run.load_module(METRICS / "idle_admm_pct.py", "t_idle_admm_pct")
idle_sqp = run.load_module(METRICS / "idle_sqp_pct.py", "t_idle_sqp_pct")
idle_inner = run.load_module(METRICS / "idle_inner_pct.py", "t_idle_inner_pct")
device_idle = run.load_module(METRICS / "device_idle_pct.py", "t_device_idle_pct")
host_reads = run.load_module(METRICS / "host_reads_per_step.py", "t_host_reads_per_step")


def _run(profile):
    return types.SimpleNamespace(profile=profile)


def _profile(host, device=(("k", 100, 300), ("k", 250, 400), ("k", 600, 700),
                           ("k", 950, 1100))):
    """Window (0, 1000); the card busy on [100, 400], [600, 700] and [950,
    1000], idle on [0, 100], [400, 600] and [700, 950]."""
    return trace.Profile(window=(0, 1000), device=list(device), host=list(host), steps=1)


UGV_HOST = [
    ("optimize", 0, 1000), ("libmpc.nlmpc.optimize", 10, 990),
    ("libmpc.sqp.loop_test", 20, 60), ("libmpc.sqp.iteration", 60, 800),
    ("libmpc.sqp.inner_qp", 80, 500), ("libmpc.admm_each.block", 90, 450),
    ("aten::mm", 420, 430), ("libmpc.sqp.loop_test", 800, 820),
    ("libmpc.sqp.iteration", 820, 980), ("libmpc.sqp.inner_qp", 900, 960),
]


def test_exact_intersections():
    p = _profile(UGV_HOST)
    # idle [20, 100] under the loop test and the first iteration outside
    # its inner QP ([20, 80]), [500, 600] and [700, 800] in the iteration
    # after it, [800, 820] in the second loop test, [820, 900] in the second
    # iteration before its inner QP
    assert idle_sqp.read(_run(p)) == pytest.approx(100 * (60 + 100 + 100 + 20 + 80) / 1000)
    # [80, 100] and [400, 500] inside the first inner QP, [900, 950] in the
    # second
    assert idle_inner.read(_run(p)) == pytest.approx(100 * (20 + 100 + 50) / 1000)
    assert idle_admm.read(_run(p)) is None  # no span of the shared ADMM


def test_admm_share_merges_its_spans_and_clips_to_the_window():
    p = _profile([("libmpc.admm.solve", -50, 150), ("libmpc.admm.solve", 120, 450),
                  ("libmpc.admm.solve", 900, 1200)])
    # [0, 100], [400, 450] and [900, 950]
    assert idle_admm.read(_run(p)) == pytest.approx(100 * (100 + 50 + 50) / 1000)


def test_shares_are_parts_of_the_device_idle_share():
    p = _profile(UGV_HOST)
    total = device_idle.read(_run(p))
    parts = idle_sqp.read(_run(p)) + idle_inner.read(_run(p))
    assert parts <= total + 1e-12
    # the SQP's spans over the whole window: the two shares are all of it
    cover = [("libmpc.sqp.loop_test", 0, 30), ("libmpc.sqp.iteration", 30, 1000),
             ("libmpc.sqp.inner_qp", 200, 650)]
    p = _profile(cover)
    total = device_idle.read(_run(p))
    assert idle_sqp.read(_run(p)) + idle_inner.read(_run(p)) == pytest.approx(total)
    assert idle_admm.read(_run(_profile([("libmpc.admm.solve", 0, 1000)]))) == (
        pytest.approx(total))


@pytest.mark.parametrize("seed", range(5))
def test_intersections_against_a_count_by_nanosecond(seed):
    rng = np.random.default_rng(seed)

    def intervals(k):
        s = rng.integers(-20, 220, size=k)
        return [(int(a), int(a + rng.integers(0, 40))) for a in s]

    device = [("k", s, e) for s, e in intervals(12)]
    host = ([("libmpc.sqp.iteration", s, e) for s, e in intervals(5)]
            + [("libmpc.sqp.loop_test", s, e) for s, e in intervals(3)]
            + [("libmpc.sqp.inner_qp", s, e) for s, e in intervals(4)])
    p = trace.Profile(window=(0, 200), device=device, host=host, steps=1)
    t = np.arange(200)
    cover = lambda iv: np.any([(t >= s) & (t < e) for s, e in iv], axis=0) if iv else (
        np.zeros(200, dtype=bool))
    idle_t = ~cover([(s, e) for _, s, e in device])
    sqp_t = cover([(s, e) for n, s, e in host if n != "libmpc.sqp.inner_qp"])
    inner_t = cover([(s, e) for n, s, e in host if n == "libmpc.sqp.inner_qp"])
    assert idle_sqp.read(_run(p)) == pytest.approx(100 * (idle_t & sqp_t & ~inner_t).sum() / 200)
    assert idle_inner.read(_run(p)) == pytest.approx(100 * (idle_t & inner_t).sum() / 200)
    assert device_idle.read(_run(p)) == pytest.approx(100 * idle_t.sum() / 200)


def test_no_profile_or_no_spans_reports_nothing():
    for reader in (idle_admm, idle_sqp, idle_inner):
        assert reader.read(_run(None)) is None
        assert reader.read(_run(_profile([("optimize", 0, 1000), ("aten::mm", 5, 9)]))) is None


def test_host_reads_per_step_divides_by_the_window_steps(monkeypatch):
    from libmpc_tpu_torch.ops import _host

    r = types.SimpleNamespace(window=types.SimpleNamespace(steps=4))
    monkeypatch.setattr(_host, "reads", 10)
    state = host_reads.open(r)
    _host.reads += 26
    state = host_reads.close(r, state)
    assert host_reads.read(r, state) == pytest.approx(26 / 4)
    r.window.steps = 0
    assert host_reads.read(r, state) is None


def test_host_reads_per_step_without_the_count(monkeypatch):
    """A program whose ``_host`` has no ``reads`` (its loops' ``flag.reads``
    alone) reports nothing."""
    from libmpc_tpu_torch.ops import _host

    monkeypatch.delattr(_host, "reads")
    r = types.SimpleNamespace(window=types.SimpleNamespace(steps=4))
    assert host_reads.read(r, host_reads.close(r, host_reads.open(r))) is None
