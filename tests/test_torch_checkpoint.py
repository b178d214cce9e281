"""Controller checkpoints of the port (``utils/checkpoint.py``): a run saved
mid-loop and resumed in a fresh controller continues bitwise as the
uninterrupted run, the files cross between the port and the JAX package,
and a file of other dimensions is refused."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libmpc_tpu as lj
import libmpc_tpu_torch as lt
from libmpc_tpu.utils import checkpoint as jck
from libmpc_tpu_torch.utils import checkpoint as tck
from test_lmpc import make_quadrotor_controller, quadrotor_model
from test_torch_lmpc import quadrotor
from test_torch_nlmpc import jax_vdp, plant_np, torch_vdp


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


LPAR = lt.LParameters(maximum_iteration=250, enable_warm_start=True)
NLKW = dict(maximum_iteration=60, enable_warm_start=True)


def lmpc_steps(c, x, u, steps):
    """A batched quadrotor closed loop: (x, u, commands)."""
    Ad, Bd, _ = quadrotor_model()
    cmds = []
    for _ in range(steps):
        r = c.optimize(x, u)
        cmds.append(r.cmd)
        u = r.cmd.numpy()
        x = x @ Ad.T + u @ Bd.T
    return x, u, cmds


def nlmpc_steps(c, x, u, steps):
    cmds = []
    for _ in range(steps):
        r = c.optimize(x, u)
        cmds.append(r.cmd)
        u = r.cmd.numpy()
        x = plant_np(x, u, 0.0)
    return x, u, cmds


def lmpc_start(B=3):
    rng = np.random.default_rng(4)
    return 0.1 * rng.normal(size=(B, 12)), np.zeros((B, 4))


def nlmpc_start(B=3):
    rng = np.random.default_rng(5)
    return rng.uniform(-1.0, 1.0, size=(B, 2)), np.zeros((B, 1))


def assert_same_run(a, b):
    assert len(a) == len(b)
    for ca, cb in zip(a, b):
        assert torch.equal(ca, cb)


def test_lmpc_resume_is_bitwise(tmp_path):
    path = str(tmp_path / "lmpc.npz")
    c1 = quadrotor(params=LPAR)
    x, u, _ = lmpc_steps(c1, *lmpc_start(), 2)
    c1.save_state(path)
    _, _, rest = lmpc_steps(c1, x, u, 2)
    c2 = quadrotor(params=LPAR)
    c2.load_state(path)
    _, _, resumed = lmpc_steps(c2, x, u, 2)
    assert_same_run(rest, resumed)


def test_nlmpc_resume_is_bitwise(tmp_path):
    path = str(tmp_path / "nlmpc.npz")
    c1 = torch_vdp(**NLKW)
    x, u, _ = nlmpc_steps(c1, *nlmpc_start(), 2)
    c1.save_state(path)
    _, _, rest = nlmpc_steps(c1, x, u, 2)
    c2 = torch_vdp(**NLKW)
    c2.load_state(path)
    assert not c2._first_iteration
    _, _, resumed = nlmpc_steps(c2, x, u, 2)
    assert_same_run(rest, resumed)


def test_lmpc_files_cross_between_the_packages(tmp_path):
    """The port's warm state written by the JAX package's ``save_lmpc``
    resumes the port bitwise; the port's file loads into the JAX controller
    with every array equal."""
    c1 = quadrotor(params=LPAR)
    x, u, _ = lmpc_steps(c1, *lmpc_start(), 2)
    jc = make_quadrotor_controller()
    jc._warm_x, jc._warm_y = (jnp.asarray(t.numpy()) for t in (c1._warm_x, c1._warm_y))
    jc._result = dataclasses.replace(jc._result, cmd=jnp.asarray(c1._result.cmd.numpy()))
    jck.save_lmpc(jc, str(tmp_path / "from_jax.npz"))
    _, _, rest = lmpc_steps(c1, x, u, 1)
    c2 = quadrotor(params=LPAR)
    c2.load_state(str(tmp_path / "from_jax.npz"))
    _, _, resumed = lmpc_steps(c2, x, u, 1)
    assert_same_run(rest, resumed)

    c2.save_state(str(tmp_path / "from_port.npz"))
    jc2 = make_quadrotor_controller()
    jc2.load_state(str(tmp_path / "from_port.npz"))
    for name in ("_warm_x", "_warm_y"):
        np.testing.assert_array_equal(np.asarray(getattr(jc2, name)),
                                      getattr(c2, name).numpy())
    np.testing.assert_array_equal(np.asarray(jc2._result.cmd), c2._result.cmd.numpy())


def test_nlmpc_files_cross_between_the_packages(tmp_path):
    c1 = torch_vdp(**NLKW)
    x, u, _ = nlmpc_steps(c1, *nlmpc_start(), 2)
    jc = jax_vdp(**NLKW)
    jc._opt_vector = jnp.asarray(c1._opt_vector.numpy())
    jc._current_slack = jnp.asarray(c1._current_slack.numpy())
    jc._first_iteration = False
    jc._result = dataclasses.replace(jc._result, cmd=jnp.asarray(c1._result.cmd.numpy()))
    jck.save_nlmpc(jc, str(tmp_path / "from_jax.npz"))
    _, _, rest = nlmpc_steps(c1, x, u, 1)
    c2 = torch_vdp(**NLKW)
    c2.load_state(str(tmp_path / "from_jax.npz"))
    _, _, resumed = nlmpc_steps(c2, x, u, 1)
    assert_same_run(rest, resumed)

    c2.save_state(str(tmp_path / "from_port.npz"))
    jc2 = jax_vdp(**NLKW)
    jc2.load_state(str(tmp_path / "from_port.npz"))
    assert jc2._first_iteration is False
    np.testing.assert_array_equal(np.asarray(jc2._opt_vector), c2._opt_vector.numpy())
    np.testing.assert_array_equal(np.asarray(jc2._current_slack), c2._current_slack.numpy())
    np.testing.assert_array_equal(np.asarray(jc2._result.cmd), c2._result.cmd.numpy())


@pytest.mark.parametrize("kind", ["lmpc", "nlmpc"])
def test_mismatched_dims_are_refused(tmp_path, kind):
    path = str(tmp_path / "ck.npz")
    if kind == "lmpc":
        c = quadrotor(params=LPAR)
        lmpc_steps(c, *lmpc_start(1), 1)
        other = lt.LMPC(2, 1, 0, 2, 3, 3, dtype=torch.float64, device="cpu")
    else:
        c = torch_vdp(**NLKW)
        nlmpc_steps(c, *nlmpc_start(1), 1)
        other = torch_vdp(ph=8, ch=4, **NLKW)
    c.save_state(path)
    with pytest.raises(ValueError, match="mismatch on 'dims'"):
        other.load_state(path)
    arrays, meta = tck.load_pytree(path)
    assert meta["kind"] == kind and meta["dims"] == list(c.dims)
    with pytest.raises(ValueError, match="mismatch on 'kind'"):
        tck.check_meta(meta, {"kind": "lmpc" if kind == "nlmpc" else "nlmpc"})
