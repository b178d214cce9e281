"""The SQP's eigenvalue clipping (``ops/batched_linalg.py::eig_clip``) on the
CPU: its plain twin is the convexification the SQP ran before K6, bit for
bit; a CPU tensor and a size past K6's shared-memory tier take the twin;
and the benchmark's reader of K6's sweep counter (``eig_sweeps_mean``).
K6 itself runs on the card only (``tests/test_torch_cuda.py``)."""

from pathlib import Path

import numpy as np
import pytest
import torch

from libmpc_tpu_torch.ops import _host, batched_linalg, sqp
from mpcbench import run

ROOT = Path(__file__).resolve().parents[1]


def _symmetric(B, n, dtype, seed=0):
    X = np.random.default_rng(seed).normal(size=(B, n, n))
    return torch.as_tensor(0.5 * (X + X.transpose(0, 2, 1)), dtype=dtype)


def _previous_convexification(H):
    """``ops/sqp.py::_eigh_convexify`` as it was before K6."""
    w, V = torch.linalg.eigh(H)
    tau = torch.clamp(1e-6 * torch.amax(torch.abs(w), dim=-1), min=1e-8)
    return (V * torch.maximum(w, tau[:, None])[:, None, :]) @ V.transpose(1, 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 5, 61])
def test_plain_twin_is_the_previous_convexification_bitwise(dtype, n):
    H = _symmetric(7, n, dtype, seed=n)
    want = _previous_convexification(H)
    assert torch.equal(batched_linalg.eig_clip_plain(H), want)
    assert torch.equal(sqp._eigh_convexify(H), want)


def test_cpu_tensor_runs_the_twin_and_reads_its_status():
    H = _symmetric(4, 61, torch.float32)
    launches, reads = batched_linalg.eig_clip.launches, _host.reads
    out = batched_linalg.eig_clip(H)
    assert torch.equal(out, batched_linalg.eig_clip_plain(H))
    assert batched_linalg.eig_clip.launches == launches
    assert _host.reads == reads + 2  # the two eigh calls' status reads


@pytest.mark.parametrize("dtype,largest", [(torch.float32, 168), (torch.float64, 118)])
def test_shared_memory_tier(dtype, largest):
    """K6 takes every n up to the largest whose block fits in 227 KB of shared
    memory; past it the library route serves (the UGV's 61 is well inside)."""
    supported = batched_linalg.eig_clip_supported
    assert all(supported(n, dtype) for n in range(1, largest + 1))
    assert not supported(largest + 1, dtype) and not supported(0, dtype)
    assert not supported(4, torch.float16)
    smem = batched_linalg.eig_clip_smem_bytes
    assert smem(largest, dtype) <= batched_linalg.EIG_SMEM_LIMIT < smem(largest + 1, dtype)
    # float32 at the UGV's n = 61: A and V of 62 rows of 63, 31 rotations
    assert smem(61, torch.float32) == (2 * 62 * 63 + 4 * 31 + 32) * 4 + 2 * 31 * 4


def test_past_the_tier_the_library_route_serves(monkeypatch):
    """A size the kernel does not take runs the twin, whatever the device
    (here a CPU tensor with the tier's test forced false and its launcher
    made to raise)."""
    H = _symmetric(3, 8, torch.float64)
    monkeypatch.setattr(batched_linalg, "eig_clip_supported", lambda n, dtype: False)
    monkeypatch.setattr(batched_linalg, "_eig_clip_launch",
                        lambda *a, **k: pytest.fail("K6 launched past its tier"))
    assert torch.equal(batched_linalg.eig_clip(H), _previous_convexification(H))


def _reader():
    return run.load_module(ROOT / "mpcbench" / "metrics" / "eig_sweeps_mean.py",
                           "test_eig_sweeps_mean")


def test_eig_sweeps_mean_on_a_hand_made_trace():
    r = _reader()
    prev = batched_linalg.eig_clip.trace
    try:
        state = r.open(None)
        assert batched_linalg.eig_clip.trace is state and state == []
        state.append(torch.tensor([0, 1, 2, 1], dtype=torch.int32))
        state.append(torch.tensor([3, 3], dtype=torch.int32))
        sweeps = r.close(None, state)
        assert batched_linalg.eig_clip.trace is None  # the counter stopped
        assert r.read(None, sweeps) == pytest.approx(10 / 6)
        # a window without a launch reports nothing
        assert r.read(None, r.close(None, r.open(None))) is None
    finally:
        batched_linalg.eig_clip.trace = prev


def test_eig_sweeps_mean_reports_nothing_without_the_counter(monkeypatch):
    """A program without K6 (an older checkout of the port) gives no reading
    and raises nothing."""
    r = _reader()
    monkeypatch.delattr(batched_linalg, "eig_clip")
    state = r.open(None)
    assert state is None and r.read(None, r.close(None, state)) is None
