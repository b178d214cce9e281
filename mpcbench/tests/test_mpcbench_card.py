"""On the card: the control comes out not correct, the program correct.

The control is the plain reference put in the program's place and computed
in the precision below the one the configuration states (float32 with TF32
products, the configurations stating float32 with TF32 off), at the states
of a short window; its lanes converge to what TF32 can reach.  Its readings at each cell's own size come from
``python3 -m mpcbench.control``; these tests hold the same at a size a test
run holds, on three seeds.  Without a card they skip.

    python3 -m pytest -q -p no:cacheprovider -m cuda mpcbench/tests/test_mpcbench_card.py
"""

from __future__ import annotations

import pytest
import torch

from mpcbench import check, control, generator, loop, run

pytestmark = pytest.mark.cuda

SIZES = [("quadrotor-lmpc.b16384", 1024, 3.0), ("ugv-nlmpc.b256", 32, 5.0)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels have no CPU mode)")
    return "cuda"


@pytest.mark.parametrize("name,batch,seconds", SIZES)
def test_control_is_not_correct(cuda, name, batch, seconds):
    cell = run.Cell(name)
    cell.traffic.update(batch=batch)
    system = cell.builder.build(cell.cfg, cell.traffic, cuda)
    loop.warm_up(system, cell.traffic, 1)
    limits = cell.cfg["check"]["limits"]
    for seed in (2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3):
        eps = generator.Episodes(cell.traffic, system.nx, system.nu, seed, 0, system.dtype,
                                 cuda)
        lanes = generator.sample_lanes(cell.traffic, seed, 4096, cuda)
        w = loop.run_window(system, loop.Loop(system, eps), lanes, seconds, False)
        samples = {k: torch.cat([s[k] for s in w.samples]) for k in w.samples[0]}
        program = control.readings(cell.builder, cell.cfg, samples, cuda, system.success)
        ctrl = control.control_samples(cell.builder, cell.cfg, samples, cuda, system.success)
        reading = control.readings(cell.builder, cell.cfg, ctrl, cuda, system.success)
        assert reading["compared"] >= 0.9 * program["compared"], reading  # it converged
        as_checks = lambda r: dict({k: (r[k], lim) for k, lim in limits.items()},
                                   compared=(r["compared"], None))
        assert check.verdict(as_checks(program)), program
        assert not check.verdict(as_checks(reading)), reading
