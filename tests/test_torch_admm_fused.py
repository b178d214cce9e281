"""K1's twin (the CPU path of ``fused_iterations``) against the Pallas
kernel ``admm_pallas.fused_iterations`` run in interpret mode, at the shapes
of tests/test_admm_pallas.py, frozen lane included."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libmpc_tpu.ops import admm_pallas
from libmpc_tpu_torch.ops import admm_fused
from test_admm_pallas import _random_problem


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _as_torch(*arrays):
    return [torch.as_tensor(np.array(a)) for a in arrays]


@pytest.mark.parametrize("refine", [True, False])
@pytest.mark.parametrize("B,n,m", [(16, 8, 12), (32, 24, 40)])
def test_twin_matches_pallas_interpret(B, n, m, refine):
    P, A, q, l, u, M, Minv, rho = _random_problem(B, n, m)
    x = jnp.zeros((B, n), jnp.float32)
    z = jnp.zeros((B, m), jnp.float32)
    y = jnp.zeros((B, m), jnp.float32)
    done = jnp.zeros((B,), bool).at[3].set(True)  # one frozen lane
    want = admm_pallas.fused_iterations(
        x, z, y, done, q, l, u, A, M, Minv, rho,
        sigma=1e-5, alpha=1.6, k_iters=10, refine=refine, interpret=True,
    )
    tx, tz, ty, tdone, tq, tl, tu, tA, tM, tMinv, trho = _as_torch(
        x, z, y, done, q, l, u, A, M, Minv, rho)
    got = admm_fused.fused_iterations(
        tx, tz, ty, tdone, tq, tl, tu, tA, tM, tMinv, trho,
        sigma=1e-5, alpha=1.6, k_iters=10, refine=refine,
    )
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-4)
    # the frozen lane is untouched, bitwise
    for g, start in zip(got, (tx, tz, ty)):
        assert torch.equal(g[3], start[3])


def test_cpu_path_is_the_plain_loop():
    P, A, q, l, u, M, Minv, rho = _random_problem(8, 6, 9, seed=2)
    args = _as_torch(q, l, u, A, M, Minv, rho)
    state = [torch.zeros((8, 6)), torch.zeros((8, 9)), torch.zeros((8, 9))]
    done = torch.zeros(8, dtype=torch.bool)
    kw = dict(sigma=1e-5, alpha=1.6, k_iters=4, refine=True)
    a = admm_fused.fused_iterations(*state, done, *args, **kw)
    b = admm_fused.plain_iterations(*state, done, *args, **kw)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    # inactive rows end with an exactly zero dual
    clipped = (a[1] <= torch.as_tensor(np.array(l))) | (a[1] >= torch.as_tensor(np.array(u)))
    assert torch.all(a[2][~clipped] == 0)


def test_tile_gate():
    f32, f64 = torch.float32, torch.float64
    # three quadrotor stream blocks fit in one SM's shared memory, and the
    # full batch runs them so: 8 lanes a block, three blocks an SM
    assert 3 * admm_fused.stream_smem_bytes(8, 216, 535, f32) <= admm_fused.SMEM_LIMIT_BYTES
    lay = admm_fused.layout(16384, 216, 535, f32)
    assert (lay.tier, lay.bt) == (0, 8)
    assert admm_fused.SMEM_LIMIT_BYTES // lay.smem_bytes >= 3
    # shapes past the staged tier run the stream tier: 8 lanes in float32, 4
    # in float64, halved until a block fits; none fits at all -> raises
    assert admm_fused.layout(64, 300, 535, f32) == (
        0, 8, 384, 8 * 4 * (3 * 300 + 2 * 535 + 535), 8, 0)
    assert admm_fused.layout(64, 300, 535, f64).bt == 4
    assert admm_fused.layout(64, 2000, 5000, f32).bt == 2
    assert admm_fused.layout(64, 4000, 10000, f32).bt == 1
    with pytest.raises(ValueError, match="shared memory"):
        admm_fused.layout(64, 8000, 20000, f64)


# the main path's batches at the quadrotor shape: (tier, lanes a block)
_QUADROTOR_LAYOUTS = {
    (torch.float32, 1): (1, 4), (torch.float32, 1003): (1, 8),
    (torch.float32, 1024): (1, 8), (torch.float32, 16384): (0, 8),
    (torch.float64, 1): (0, 4), (torch.float64, 1003): (0, 4),
    (torch.float64, 1024): (0, 4), (torch.float64, 16384): (0, 4),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B", [1, 1003, 1024, 16384])
def test_layout_fits_the_block_and_fills_the_card(B, dtype):
    """The quadrotor shape: float32 runs the staged tier while the batch fits
    one wave of 8-lane tiles (the compacted stragglers, a single QP) and the
    stream tier past it; float64 the stream tier (PERF.md gives the
    timings behind the costs).  A staged block fits its shared memory with
    as many ring stages as fit, and a batch of 1,024 puts a block on at
    least 95 % of the SMs."""
    lay = admm_fused.layout(B, 216, 535, dtype)
    assert (lay.tier, lay.bt) == _QUADROTOR_LAYOUTS[(dtype, B)]
    assert lay.grid == -(-B // lay.bt)
    if B >= 1024:
        assert lay.grid >= 0.95 * admm_fused.H100_SMS
    if lay.tier == 0:
        assert lay.smem_bytes == admm_fused.stream_smem_bytes(lay.bt, 216, 535, dtype)
        return
    assert lay.threads == 16 * lay.bt
    assert lay.smem_bytes == admm_fused.staged_smem_bytes(lay.bt, 216, 535, lay.stages)
    assert lay.smem_bytes <= admm_fused.SMEM_LIMIT_BYTES
    assert 2 <= lay.stages <= admm_fused.MAX_STAGES
    assert lay.stages == admm_fused.MAX_STAGES or admm_fused.staged_smem_bytes(
        lay.bt, 216, 535, lay.stages + 1) > admm_fused.SMEM_LIMIT_BYTES


def test_staged_shared_memory_is_pinned():
    # (216, 535): vector rows padded to 220 / 540 / 36 floats; ring rows of
    # 216 as in the matrix, and 8 floats of slack
    assert admm_fused.staged_smem_bytes(16, 216, 535, 4) == 4 * (
        16 * (3 * 220 + 2 * 540 + 36) + 4 * 32 * 216 + 8) == 224288
    assert admm_fused.staged_smem_bytes(8, 216, 535, 2) == 4 * (
        8 * (3 * 220 + 2 * 540 + 36) + 2 * 32 * 216 + 8) == 112160
    assert admm_fused.staged_smem_bytes(24, 216, 535, 4) > admm_fused.SMEM_LIMIT_BYTES
    # a vector row of 20 floats is 80 bytes, 16 mod 32: no pad; 40 -> 44
    assert admm_fused.staged_smem_bytes(4, 20, 40) == 4 * (
        4 * (3 * 20 + 2 * 44 + 36) + 2 * 32 * 20 + 8)
    # every tile fits with four stages at the card tests' and the quadrotor
    # shapes
    for n, m in ((24, 40), (216, 535)):
        assert all(admm_fused.staged_smem_bytes(bt, n, m, 4) <= admm_fused.SMEM_LIMIT_BYTES
                   for bt in admm_fused.STAGED_TILES)


@pytest.mark.parametrize("n,m,dtype,aligned", [
    (13, 40, torch.float32, True),   # 52-byte rows
    (24, 40, torch.float64, True),   # float64
    (257, 40, torch.float32, True),  # past 256 columns
    (24, 40, torch.float32, False),  # a matrix not 16-byte aligned
])
def test_layout_runs_other_shapes_on_the_stream_tier(n, m, dtype, aligned):
    assert admm_fused.layout(100, n, m, dtype, aligned).tier == 0
    # the staged tier's shapes: float32, n <= 256 and a multiple of 4 (the
    # last case has one, but a misaligned matrix)
    assert admm_fused.staged_shape(n, m, dtype) == (not aligned)


def test_forced_tile_and_the_cost_model():
    lay = admm_fused.staged_layout(16384, 216, 535, bt=8)
    assert (lay.tier, lay.bt, lay.grid, lay.stages) == (1, 8, 2048, 4)
    lay = admm_fused.staged_layout(16384, 216, 535, bt=8, stages=2)
    assert (lay.bt, lay.stages) == (8, 2)
    assert admm_fused.stream_layout(1024, 216, 535, torch.float32) == (
        0, 8, 384, admm_fused.stream_smem_bytes(8, 216, 535, torch.float32), 128, 0)
    # no such tile, too few or too many stages, a tile past the shared memory
    assert admm_fused.staged_layout(16384, 216, 535, bt=12) is None
    assert admm_fused.staged_layout(16384, 216, 535, bt=8, stages=1) is None
    assert admm_fused.staged_layout(16384, 216, 535, bt=8, stages=5) is None
    assert admm_fused.staged_layout(16384, 256, 2000, bt=16) is None
    # the cost model: the staged tile of least ceil(ceil(B / bt) / SMs) *
    # (bt + TILE_COST), against ceil(blocks / (3 SMs)) * STREAM_WAVE_COST for
    # the stream tier's 8 lanes a block
    for B in (1, 37, 1003, 1024, 1056, 1057, 2048, 4096, 16384):
        lay = admm_fused.layout(B, 216, 535, torch.float32)
        cost = lambda bt: -(-(-(-B // bt)) // 132) * (bt + admm_fused.TILE_COST)
        staged = min(cost(bt) for bt in admm_fused.STAGED_TILES)
        stream = -(-(-(-B // 8)) // (3 * 132)) * admm_fused.STREAM_WAVE_COST
        assert lay.tier == (1 if staged < stream else 0), B
        if lay.tier == 1:
            assert cost(lay.bt) == staged and all(
                cost(bt) > staged for bt in admm_fused.STAGED_TILES if bt > lay.bt)


def test_non_cpu_devices_never_reach_the_twin():
    launches = admm_fused.fused_iterations.launches
    t = lambda *s: torch.empty(s, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        admm_fused.fused_iterations(
            t(4, 3), t(4, 5), t(4, 5), torch.empty(4, dtype=torch.bool, device="meta"),
            t(4, 3), t(4, 5), t(4, 5), t(5, 3), t(3, 3), t(3, 3), t(5),
            sigma=1e-5, alpha=1.6, k_iters=2,
        )
    assert admm_fused.fused_iterations.launches == launches


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_forced_layout_runs_only_on_the_card(device):
    """``launch`` (a layout forced for tests and sweeps) never runs the twin:
    a tensor off the card raises and counts no launch."""
    launches = admm_fused.fused_iterations.launches
    t = lambda *s: torch.zeros(s, device=device)
    lay = admm_fused.stream_layout(4, 3, 5, torch.float32)
    with pytest.raises(ValueError, match="unsupported device"):
        admm_fused.launch(
            lay, t(4, 3), t(4, 5), t(4, 5), torch.zeros(4, dtype=torch.bool, device=device),
            t(4, 3), t(4, 5), t(4, 5), t(5, 3), t(3, 3), t(3, 3), t(5),
            sigma=1e-5, alpha=1.6, k_iters=2,
        )
    assert admm_fused.fused_iterations.launches == launches
