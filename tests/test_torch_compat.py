"""The port's pympcxx layer (``libmpc_tpu_torch.compat``) against the JAX
package's (``libmpc_tpu.compat``): every case of tests/test_compat.py, the
same scripts through both layers in float64 on the CPU."""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libmpc_tpu.compat as jmpc
import libmpc_tpu_torch.compat as mpc

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the repository root's smoke script; imports no JAX)

CPU64 = dict(dtype=torch.float64, device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def test_quadrotor_golden_via_compat():
    res, seq = chip_smoke.compat_quadrotor(mpc, **CPU64)
    jres, _ = chip_smoke.compat_quadrotor(jmpc)
    cmd = res.cmd.numpy()
    assert np.allclose(cmd, chip_smoke.GOLDEN_CMD, atol=1e-4)
    assert np.abs(cmd - np.asarray(jres.cmd)).max() <= 1e-6
    assert res.status_enum == mpc.SUCCESS == jres.status_enum
    assert tuple(seq.state.shape) == (11, 12)
    assert seq.state.dtype == torch.float64 and seq.state.device.type == "cpu"


def test_example_nl_eight_steps_match_jax():
    """tests/test_compat.py::test_example_nl's loop, 8 closed-loop steps (the
    float64 Van der Pol step costs about a second here): the commands of
    each step within 1e-6 of the JAX layer's, one solution counted a step."""
    steps, _, cmds, stats = chip_smoke.compat_example_nl(mpc, torch, steps=8, **CPU64)
    jsteps, _, jcmds, jstats = chip_smoke.compat_example_nl(jmpc, jnp, steps=8)
    assert steps == jsteps == 8
    assert np.abs(cmds - jcmds).max() <= 1e-6
    assert cmds.max() <= 0.5 + 1e-6
    assert isinstance(stats, mpc.SolutionStats)
    assert stats.number_of_solutions == jstats.number_of_solutions == 8


def test_scalar_constraint_overloads():
    """Both overloads succeed and leave the problem record the JAX layer's."""
    def record(layer, overload, **kw):
        c = layer.LMPC(2, 1, 0, 2, 5, 5, **kw)
        args = ((-1.0, 1.0, np.ones(2), np.ones(1), layer.HorizonSlice.all()),
                (0, -1.0, 1.0, np.ones(2), np.ones(1)))[overload]
        assert c.setScalarConstraint(*args)
        return {f: np.asarray(getattr(c._c._prob, f)) for f in ("s_min", "s_max", "s_mult")}

    for overload in (0, 1):
        got = record(mpc, overload, **CPU64)
        want = record(jmpc, overload)
        for f in want:
            assert np.array_equal(got[f], want[f]), (overload, f)
    # an index past the horizon is refused by both
    assert not mpc.LMPC(2, 1, 0, 2, 5, 5, device="cpu").setScalarConstraint(
        5, -1.0, 1.0, np.ones(2), np.ones(1))


@pytest.mark.parametrize("name", ["LParameters", "NLParameters"])
def test_parameter_objects_mutable_with_jax_defaults(name):
    p, jp = getattr(mpc, name)(), getattr(jmpc, name)()
    assert vars(p) == vars(jp)
    p.maximum_iteration = 42
    if name == "LParameters":
        p.rho = 0.5
        frozen = p._frozen()
        assert frozen.maximum_iteration == 42 and frozen.rho == 0.5
    else:
        p.hard_constraints = False
        frozen = p._frozen()
        assert frozen.maximum_iteration == 42 and frozen.hard_constraints is False
    assert type(frozen) is getattr(mpc._t, name)


def test_module_scope_types_match_pybind_export():
    """Every module-scope name of the JAX layer (and of the reference
    binding, python/pybind_export.cpp:129-212) exists here."""
    assert mpc.__all__ == jmpc.__all__
    for name in mpc.__all__:
        assert hasattr(mpc, name), name
    for name in ("UNKNOWN", "SUCCESS", "MAX_ITERATION", "INFEASIBLE", "ERROR",
                 "DEEP", "NORMAL", "ALERT", "NONE"):
        assert int(getattr(mpc, name)) == int(getattr(jmpc, name)), name
    assert mpc.SUCCESS == mpc.ResultStatus.SUCCESS
    assert mpc.NORMAL == mpc.LoggerLevel.NORMAL
