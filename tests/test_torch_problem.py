"""QP assembly, unpack and warm-start shift: the port against the JAX
package on the same random problem data, in float64 to 1e-12."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libmpc_tpu.dims import LDims as JLDims
from libmpc_tpu.lmpc import problem as jqp
from libmpc_tpu_torch import convert
from libmpc_tpu_torch.dims import LDims
from libmpc_tpu_torch.lmpc import problem as tqp

DIMS = [
    (12, 4, 4, 12, 10, 10),  # quadrotor
    (5, 3, 3, 7, 7, 5),
    (5, 3, 1, 1, 1, 1),
    (1, 1, 0, 1, 3, 2),
]
TOL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _random_problem(dims, rng, batch=()):
    """Problem arrays with finite and infinite bounds (numpy, float64)."""
    nx, nu, ndu, ny, ph, ch = dims
    nxu = nx + nu
    A, B, C = (rng.normal(size=s) for s in ((nx, nx), (nx, nu), (ny, nx)))
    Bd, Dd = rng.normal(size=(nx, ndu)), rng.normal(size=(ny, ndu))
    ssA, ssB, ssC = (np.asarray(a) for a in jqp.make_augmented_model(
        jnp.asarray(A), jnp.asarray(B), jnp.asarray(C)))
    ssBv, ssDv = (np.asarray(a) for a in jqp.make_disturbance_model(
        jnp.asarray(Bd), jnp.asarray(Dd), nu))

    def bounds(shape):
        lo = -rng.uniform(0.5, 2.0, size=batch + shape)
        lo[rng.random(size=lo.shape) < 0.3] = -np.inf
        hi = rng.uniform(0.5, 2.0, size=batch + shape)
        hi[rng.random(size=hi.shape) < 0.3] = np.inf
        return lo, hi

    min_x, max_x = bounds((ph + 1, nx))
    min_y, max_y = bounds((ph + 1, ny))
    min_u, max_u = bounds((ph, nu))
    s_min, s_max = bounds((ph + 1,))
    return dict(
        ssA=ssA, ssB=ssB, ssC=ssC, ssBv=ssBv, ssDv=ssDv,
        w_out=rng.uniform(0, 5, size=(ph + 1, ny)),
        w_u=rng.uniform(0, 1, size=(ph + 1, nu)),
        w_du=rng.uniform(0, 1, size=(ph, nu)),
        min_x=min_x, max_x=max_x, min_y=min_y, max_y=max_y,
        min_u=min_u, max_u=max_u, s_min=s_min, s_max=s_max,
        s_mult=rng.normal(size=(nxu,)),
    )


def _both(arrays):
    return (jqp.LProblemData(**{k: jnp.asarray(v) for k, v in arrays.items()}),
            convert.problem_from_numpy(arrays))


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=tol)


@pytest.mark.parametrize("dims", DIMS)
def test_augmented_and_disturbance_models(dims):
    rng = np.random.default_rng(1)
    nx, nu, ndu, ny = dims[:4]
    A, B, C = rng.normal(size=(nx, nx)), rng.normal(size=(nx, nu)), rng.normal(size=(ny, nx))
    for t, j in zip(tqp.make_augmented_model(*map(torch.as_tensor, (A, B, C))),
                    jqp.make_augmented_model(*map(jnp.asarray, (A, B, C)))):
        _close(t, j, 0.0)
    Bd, Dd = rng.normal(size=(nx, ndu)), rng.normal(size=(ny, ndu))
    for t, j in zip(tqp.make_disturbance_model(torch.as_tensor(Bd), torch.as_tensor(Dd), nu),
                    jqp.make_disturbance_model(jnp.asarray(Bd), jnp.asarray(Dd), nu)):
        _close(t, j, 0.0)


@pytest.mark.parametrize("batch", [(), (3,)])
@pytest.mark.parametrize("dims", DIMS)
def test_assembly_matches_jax(dims, batch):
    rng = np.random.default_rng(sum(dims) + len(batch))
    nx, nu, ndu, ny, ph, ch = dims
    jprob, tprob = _both(_random_problem(dims, rng, batch))
    jd, td = JLDims(*dims), LDims(*dims)

    jres = jqp.build_time_invariant(jd, jprob)
    tres = tqp.build_time_invariant(td, tprob)
    for t, j in zip(tres, jres):
        assert t.shape == j.shape
        _close(t, j)

    x0 = rng.normal(size=batch + (nx,))
    u0 = rng.normal(size=batch + (nu,))
    refs = [rng.normal(size=(ph, w)) for w in (ny, nu, nu, ndu)]
    jq = jqp.build_time_varying(jd, jprob, jres[2], jres[3], jnp.asarray(x0),
                                jnp.asarray(u0), *map(jnp.asarray, refs))
    tq = tqp.build_time_varying(td, tprob, tres[2], tres[3], torch.as_tensor(x0),
                                torch.as_tensor(u0), *map(torch.as_tensor, refs))
    for t, j in zip(tq, jq):
        assert t.shape == j.shape
        _close(t, j)


@pytest.mark.parametrize("dims", DIMS)
def test_unpack_shift_and_output_match_jax(dims):
    rng = np.random.default_rng(7 + sum(dims))
    nx, nu, ndu, ny, ph, ch = dims
    jprob, tprob = _both(_random_problem(dims, rng))
    jd, td = JLDims(*dims), LDims(*dims)
    z = rng.normal(size=(4, td.nz))
    u_meas = rng.normal(size=(ph, ndu))
    for t, j in zip(tqp.unpack_solution(td, tprob, torch.as_tensor(z), torch.as_tensor(u_meas)),
                    jqp.unpack_solution(jd, jprob, jnp.asarray(z), jnp.asarray(u_meas))):
        _close(t, j)

    wx, wy = rng.normal(size=(4, td.nz)), rng.normal(size=(4, td.m))
    for t, j in zip(tqp.shift_warm_start(td, torch.as_tensor(wx), torch.as_tensor(wy)),
                    jqp.shift_warm_start(jd, jnp.asarray(wx), jnp.asarray(wy))):
        _close(t, j, 0.0)

    state, dist = rng.normal(size=(5, nx)), rng.normal(size=(5, ndu))
    _close(tqp.map_to_output(tprob, ny, nx, torch.as_tensor(state), torch.as_tensor(dist)),
           jqp.map_to_output(jprob, ny, nx, jnp.asarray(state), jnp.asarray(dist)))


def test_init_problem_matches_jax():
    dims = (5, 3, 3, 7, 7, 5)
    jp = jqp.init_problem(JLDims(*dims), jnp.float64)
    tp = tqp.init_problem(LDims(*dims), torch.float64)
    for f in dataclasses.fields(tp):
        _close(getattr(tp, f.name), getattr(jp, f.name), 0.0)


def test_convert_roundtrip():
    rng = np.random.default_rng(3)
    arrays = _random_problem((5, 3, 3, 7, 7, 5), rng)
    back = convert.problem_to_numpy(convert.problem_from_numpy(arrays))
    for k, v in arrays.items():
        np.testing.assert_array_equal(back[k], v)
    x, y = convert.warm_start_from_numpy(np.ones(4), np.zeros(3))
    bx, by = convert.warm_start_to_numpy(x, y)
    np.testing.assert_array_equal(bx, np.ones(4))
    with pytest.raises(KeyError):
        convert.problem_from_numpy({"ssA": arrays["ssA"]})
