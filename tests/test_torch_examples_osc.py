"""The networked-oscillators example configuration on the port against the
JAX package (tests/test_examples.py::TestNetworkedOscillators at its small
size, float64 on the CPU), and the import boundary of the user surface."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libmpc_tpu_torch as lt
from libmpc_tpu import NLMPC as JNLMPC, NLParameters as JNLParameters

ROOT = Path(__file__).resolve().parents[1]
CPU64 = dict(dtype=torch.float64, device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def test_oscillators_input_cap_and_progress_match_jax():
    """tests/test_examples.py::TestNetworkedOscillators at N=3, ph=8: ten
    steps within 1e-6 of the JAX package, the cap held, the energy down."""
    N = 3
    nx, nu = 2 * N, N
    ph, ch = 8, 4
    mu, k, ts = 1.0, 0.1, 0.1

    def dyn(x, u, step):  # no in-place writes (torch.func differentiates it)
        pos, vel = x[0::2], x[1::2]
        coupling = k * (torch.sum(pos) - N * pos)
        dvel = mu * (1.0 - pos**2) * vel - pos + u + coupling
        return torch.stack((vel, dvel), -1).reshape(-1)

    def jdyn(x, u, step):
        pos, vel = x[0::2], x[1::2]
        coupling = k * (jnp.sum(pos) - N * pos)
        dvel = mu * (1.0 - pos**2) * vel - pos + u + coupling
        return jnp.zeros_like(x).at[0::2].set(vel).at[1::2].set(dvel)

    def run(c, f, xp, as_array):
        c.set_discretization_sampling_time(ts)
        c.set_state_space_function(f)
        c.set_objective_function(lambda X, Y, U, e: xp.sum(X**2) + xp.sum(U**2))
        c.set_ineq_con_function(lambda X, Y, U, e: (U - 0.5).reshape(-1))
        x = np.zeros(nx)
        x[0] = 1.0
        cmd, cmds = np.zeros(nu), []
        for _ in range(10):
            cmd = np.asarray(c.optimize(x, cmd).cmd, dtype=float)
            cmds.append(cmd)
            x = x + np.asarray(f(as_array(x), as_array(cmd), 0)) * ts
        return np.array(cmds), x

    c = lt.NLMPC(nx, nu, nx, ph, ch, (ph + 1) * nu, 0, **CPU64)
    c.set_optimizer_parameters(lt.NLParameters(maximum_iteration=60))
    cmds, x = run(c, dyn, torch, _t)
    jc = JNLMPC(nx, nu, nx, ph, ch, (ph + 1) * nu, 0)
    jc.set_optimizer_parameters(JNLParameters(maximum_iteration=60))
    jcmds, _ = run(jc, jdyn, jnp, jnp.asarray)
    assert np.abs(cmds - jcmds).max() <= 1e-6
    assert cmds.max() <= 0.5 + 1e-6
    assert np.sum(x**2) < 1.0  # energy decreased under control


def test_surface_imports_neither_jax_nor_the_jax_package():
    """``compat``, ``native_qp``, ``utils.flops`` and every example of
    ``examples/torch`` load in a fresh interpreter without JAX or
    ``libmpc_tpu``."""
    code = (
        "import json, sys\n"
        "import libmpc_tpu_torch.compat, libmpc_tpu_torch.native_qp\n"
        "import libmpc_tpu_torch.utils.flops\n"
        "import chip_smoke\n"
        "for name in chip_smoke.SURFACE_EXAMPLES:\n"
        "    chip_smoke.load_example(name)\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, check=True,
                         capture_output=True, text=True, timeout=120)
    mods = json.loads(out.stdout.splitlines()[-1])
    examples = [m for m in mods if m.startswith("torch_example_")]
    assert len(examples) == 6
    assert not [m for m in mods if m == "jax" or m.startswith("jax.")]
    assert not [m for m in mods if m == "libmpc_tpu" or m.startswith("libmpc_tpu.")]
