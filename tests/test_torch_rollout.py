"""The port's closed-loop rollouts (``rollout.py``) against the JAX
package's scanned rollouts and the float64 closed-loop oracle."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libmpc_tpu_torch as lt
from libmpc_tpu.rollout import nlmpc_rollout as jax_nlmpc_rollout
from test_lmpc import quadrotor_model
from test_torch_lmpc import closed_loop_params, quadrotor
from test_torch_nlmpc import jax_vdp, jvdp, torch_vdp, tvdp, vdp_inputs

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def torch_plant(noise):
    f = torch.func.vmap(tvdp, in_dims=(0, 0, None))
    return lambda x, u, k: x + 0.1 * f(x, u, k) + noise[k]


def test_nlmpc_rollout_matches_jax_float64():
    """B = 4, K = 4, the bench's plant (``x + 0.1 f(x, u) + noise[k]``),
    float64: statuses and SQP iteration counts equal at every lane-step,
    commands, states and costs within 1e-9."""
    B, K = 4, 4
    kw = dict(maximum_iteration=30, enable_warm_start=True, inner_qp="fused",
              hessian_reg="gershgorin")
    x0, noise = vdp_inputs(B, K)
    jn = jnp.asarray(noise)
    jplant = lambda x, u, k: x + 0.1 * jax.vmap(jvdp, in_axes=(0, 0, None))(x, u, k) + jn[k]
    rj = jax_nlmpc_rollout(jax_vdp(**kw), jplant, x0, np.zeros((B, 1)), K)
    tc = torch_vdp(**kw)
    rt = lt.nlmpc_rollout(tc, torch_plant(torch.as_tensor(noise)), x0, np.zeros((B, 1)), K)
    assert isinstance(rt, lt.Rollout)
    assert rt.states.shape == (B, K + 1, 2) and rt.inputs.shape == (B, K, 1)
    np.testing.assert_array_equal(rt.statuses.numpy(), np.asarray(rj.statuses))
    np.testing.assert_array_equal(rt.iterations.numpy(), np.asarray(rj.iterations))
    for name in ("inputs", "states", "costs"):
        np.testing.assert_allclose(getattr(rt, name).numpy(), np.asarray(getattr(rj, name)),
                                   rtol=0, atol=1e-9, err_msg=name)
    assert tc._opt_vector is None  # the controller's own warm start is untouched
    # chunked: the same per-lane solve sequence
    rc = lt.nlmpc_rollout(torch_vdp(**kw), torch_plant(torch.as_tensor(noise)), x0,
                          np.zeros((B, 1)), K, chunk_steps=3)
    assert torch.equal(rc.inputs, rt.inputs) and torch.equal(rc.iterations, rt.iterations)


def test_nlmpc_rollout_unbatched_params_fn_and_rescue_message(capsys):
    """An unbatched rollout with ``params_fn`` (a reference that follows the
    state) equals the host loop over ``optimize``; ``rescue_iters`` with an
    engine it cannot deepen only logs the JAX package's message."""
    kw = dict(maximum_iteration=30, enable_warm_start=True)
    obj = lambda X, Y, U, e, p: torch.sum((X - p) ** 2) + torch.sum(U**2)
    plant = lambda x, u, k: x + 0.1 * tvdp(x, u, k)
    pfn = lambda x, k: 0.5 * x
    a = torch_vdp(**kw)
    a.set_objective_function(obj)
    a.set_runtime_params(torch.zeros(2, dtype=torch.float64))
    r = lt.nlmpc_rollout(a, plant, np.array([0.0, 1.0]), np.zeros(1), 3, params_fn=pfn)
    assert r.inputs.shape == (3, 1) and r.states.shape == (4, 2) and r.statuses.shape == (3,)
    b = torch_vdp(**kw)
    b.set_objective_function(obj)
    x, u = torch.tensor([0.0, 1.0], dtype=torch.float64), torch.zeros(1, dtype=torch.float64)
    for k in range(3):
        b.set_runtime_params(pfn(x, k))
        u = b.optimize(x, u).cmd
        assert torch.allclose(u, r.inputs[k], rtol=0, atol=1e-12)
        x = plant(x, u, k)
    c = torch_vdp(rescue_iters=60, inner_qp="pdip", **kw)
    lt.Logger._reset_for_tests()
    lt.Logger.instance().set_level(lt.LogLevel.NORMAL)
    try:
        lt.nlmpc_rollout(c, lambda x, u, k: x, np.zeros((2, 2)), np.zeros((2, 1)), 1)
    finally:
        lt.Logger._reset_for_tests()
    assert "rescue phase disabled" in capsys.readouterr().out


@pytest.mark.parametrize("B,over", [(64, False), (192, True)])
def test_nlmpc_rollout_rescue_matches_jax_float64(B, over):
    """The compacted two-phase rescue: a cap of 2 interior-point iterations
    makes some lanes fail the fast phase of the second step, and the rescue
    re-solves them at a cap of 45.  Statuses, summed iteration counts,
    commands and states equal the JAX package's ``nlmpc_rollout``; at
    B = 192 more lanes fail than the rescue takes (16), so the highest
    failed lanes keep their hold-last-command result in both packages."""
    K = 2
    kw = dict(maximum_iteration=12, enable_warm_start=True, inner_qp="riccati",
              hessian_reg="gershgorin", inner_iters=2, inner_iters_recovery=2,
              rescue_iters=45)
    x0, noise = vdp_inputs(B, K)
    x0 = 2.0 * x0
    jn = jnp.asarray(noise)
    jplant = lambda x, u, k: x + 0.1 * jax.vmap(jvdp, in_axes=(0, 0, None))(x, u, k) + jn[k]
    rj = jax_nlmpc_rollout(jax_vdp(**kw), jplant, x0, np.zeros((B, 1)), K)
    lt.nlmpc_rollout.rescued = []
    try:
        rt = lt.nlmpc_rollout(torch_vdp(**kw), torch_plant(torch.as_tensor(noise)), x0,
                              np.zeros((B, 1)), K)
        counts = lt.nlmpc_rollout.rescued
    finally:
        lt.nlmpc_rollout.rescued = None
    failed, rescued = counts[1]
    assert len(counts) == K and 0 < rescued <= 16
    assert (failed > 16) == over and rescued == min(failed, 16)
    err = int(lt.ResultStatus.ERROR)
    assert int((rt.statuses[:, 1] == err).sum()) == failed - rescued
    np.testing.assert_array_equal(rt.statuses.numpy(), np.asarray(rj.statuses))
    np.testing.assert_array_equal(rt.iterations.numpy(), np.asarray(rj.iterations))
    for name in ("inputs", "states", "costs"):
        np.testing.assert_allclose(getattr(rt, name).numpy(), np.asarray(getattr(rj, name)),
                                   rtol=0, atol=1e-9, err_msg=name)


def test_nlmpc_rollout_rescue_keeps_a_lane_whose_rescue_fails_too():
    """A lane with a NaN state fails both phases: it holds its last command
    with status ERROR, counts as failed and not as rescued, and the other
    lanes are untouched by the rescue."""
    kw = dict(maximum_iteration=12, enable_warm_start=True, inner_qp="riccati",
              hessian_reg="gauss_newton", rescue_iters=45)
    x0, _ = vdp_inputs(3, 1)
    x0[1] = np.nan
    u0 = np.full((3, 1), 0.25)
    lt.nlmpc_rollout.rescued = []
    try:
        r = lt.nlmpc_rollout(torch_vdp(**kw), lambda x, u, k: x, x0, u0, 1)
        counts = lt.nlmpc_rollout.rescued
    finally:
        lt.nlmpc_rollout.rescued = None
    assert counts == [(1, 0)]
    assert r.statuses[:, 0].tolist() == [0, int(lt.ResultStatus.ERROR), 0]
    assert float(r.inputs[1, 0, 0]) == 0.25 and torch.isinf(r.costs[1, 0])
    plain = lt.nlmpc_rollout(torch_vdp(**dict(kw, rescue_iters=0)), lambda x, u, k: x,
                             x0, u0, 1)
    assert torch.equal(plain.inputs[[0, 2]], r.inputs[[0, 2]])
    assert torch.equal(plain.iterations, r.iterations)


def test_lmpc_rollout_matches_the_float64_oracle_at_matched_states():
    """``lmpc_rollout`` with the production float32 settings, teleported
    onto the states of ``misc/results/closed_loop_ref_f64.npz`` (first 16
    lanes, 16 steps): warm-step command error within the matched-state
    figures of docs/performance.md:58 (mean 1.5e-6, max 8.1e-4), and every
    lane-step SUCCESS.  The rollout equals the host loop over ``optimize``."""
    ref = np.load(ROOT / "misc" / "results" / "closed_loop_ref_f64.npz")
    B = 16
    states = torch.as_tensor(ref["states"][:B], dtype=torch.float32)
    K = states.shape[1] - 1
    c = quadrotor(torch.float32, closed_loop_params())
    r = lt.lmpc_rollout(c, lambda x, u, k: states[:, k + 1], states[:, 0],
                        np.zeros((B, 4)), K)
    assert r.inputs.shape == (B, K, 4) and r.states.shape == (B, K + 1, 12)
    assert (r.statuses == 0).all() and r.iterations.dtype == torch.int32
    err = np.abs(r.inputs.numpy() - ref["inputs"][:B]).max(axis=-1)
    assert err[:, 1:].mean() <= 1.5e-6 and err[:, 1:].max() <= 8.1e-4
    assert err[:, 0].mean() <= 7.5e-4
    h = quadrotor(torch.float32, closed_loop_params())
    u = torch.zeros((B, 4))
    for k in range(3):
        u = h.optimize(states[:, k], u).cmd
        assert torch.equal(u, r.inputs[:, k])


def test_lmpc_rollout_float64_free_trajectory():
    """Float64, the default settings, plant = model: the rollout's first
    commands are the golden trajectory's (``quadrotor_cmds``, 1e-6)."""
    golden = np.load(ROOT / "tests" / "golden_trajectories.npz")["quadrotor_cmds"]
    Ad, Bd, _ = quadrotor_model()
    A, Bm = torch.as_tensor(Ad), torch.as_tensor(Bd)
    r = lt.lmpc_rollout(quadrotor(), lambda x, u, k: A @ x + Bm @ u, np.zeros(12),
                        np.zeros(4), 5)
    assert r.inputs.shape == (5, 4) and r.states.shape == (6, 12)
    np.testing.assert_allclose(r.inputs.numpy(), golden[:5], rtol=0, atol=1e-6)
