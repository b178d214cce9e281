"""A run whose timed path is broken underneath comes out not correct.

Each test drives the rest of a run on the CPU (tiny batch, short window,
the look for a card skipped) with one fault of :mod:`mpcbench.faults`
planted in the controller's ``optimize`` as the window calls it, and sees
``correct`` false.  Each batch is even, so ``half`` leaves out exactly half
of it, as at the cells' own sizes.  The UGV cell compares medians and a
quartile only (its widest gaps are no tighter than its control's,
``PERF.md``), so one altered command among its lanes is not a fault it can
catch.
"""

from __future__ import annotations

import pytest
import torch

from mpcbench import faults, run

CASES = [("quadrotor-lmpc.b16384", 8, 2.0, fault)
         for fault in ("none", "stale", "half", "altered")] + [
    ("ugv-nlmpc.b256", 4, 0.1, fault) for fault in ("none", "stale", "half")]


@pytest.mark.parametrize("name,batch,seconds,fault", CASES)
def test_a_broken_timed_path_is_not_correct(name, batch, seconds, fault):
    cell = run.Cell(name)
    # every lane of every step kept, so a single altered answer is among them
    cell.traffic.update(batch=batch, warmup_steps=1, episode_steps=4,
                        check_lanes_per_step=4 * batch)
    hook = faults.FAULTS.get(fault)
    res, checks = run.measure(cell, 2 ** 31 + 101, seconds, False, device="cpu", hook=hook)
    assert res["correct"] is (fault == "none"), checks
    assert torch.isfinite(torch.tensor(checks["cmd_gap_median"][0]))
