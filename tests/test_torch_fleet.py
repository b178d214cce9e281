"""The port's batch-sharded fleets (``libmpc_tpu_torch/parallel``) over
``torch.distributed`` on CPU gloo ranks.

The module fixture spawns this file as four rank processes
(``python tests/test_torch_fleet.py --rank r ...``), once for the module.
Each rank imports only torch, numpy, the port and ``chip_smoke.py``'s
controller setups (neither JAX nor the JAX package), joins a gloo process
group through a file store with a 60 s collective timeout, runs every
scenario below in the same order and writes what it saw to
``rank<r>.npz``; each test asserts on those files.

The JAX package is the reference: the same numpy inputs go through its
``LMPCFleet`` on a four-device mesh (each shard's adaptive rho is its own,
so the shards must be the ranks') and its ``NLMPCFleet`` on eight devices
(one lane a device: see ``jax_ref``), commands within 1e-8, statuses,
iteration counts and every ``FleetStats`` field equal, and fleet
checkpoint files cross between the packages both ways.  The cases of
``tests/test_parallel.py`` are held as that file holds the JAX fleets
(against the port's own unsharded controller, or by the invariant it
asserts), and the cross-process golden of ``tests/test_multihost.py`` is
checked on every rank.
"""

import argparse
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
WORLD = 4
COLLECTIVE_TIMEOUT_S = 60
SPAWN_TIMEOUT_S = 300
GOLDEN_CMD = np.array([-0.9916, 1.74839, -0.9916, 1.74839])
STATS_FIELDS = ("n_total", "n_success", "n_max_iteration", "n_infeasible",
                "n_error", "n_unknown", "mean_iterations", "max_iterations")


# -- inputs shared by both packages (numpy only) -------------------------------
def quadrotor_model():
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    return chip_smoke.quadrotor_model()


def lmpc_parity_inputs(steps=3, B=16):
    """Per-step (x, last_u) of the LMPC parity run: a quadrotor fleet driven
    by a fixed command sequence, so both packages see the same states."""
    Ad, Bd = quadrotor_model()
    rng = np.random.default_rng(0)
    x, u = 0.05 * rng.normal(size=(B, 12)), np.zeros((B, 4))
    out = []
    for _ in range(steps):
        out.append((x, u))
        u = 0.2 * rng.normal(size=(B, 4))
        x = x @ Ad.T + u @ Bd.T
    return out


def vdp_step(x, u):
    f = np.stack([(1.0 - x[:, 1] ** 2) * x[:, 0] - x[:, 1] + u[:, 0], x[:, 0]], axis=1)
    return x + 0.1 * f


def nlmpc_parity_inputs(steps=2, B=8):
    rng = np.random.default_rng(2)
    x, u = rng.uniform(-1, 1, size=(B, 2)), np.zeros((B, 1))
    out = []
    for _ in range(steps):
        out.append((x, u))
        u = 0.2 * rng.uniform(-1, 1, size=(B, 1))
        x = vdp_step(x, u)
    return out


LMPC_PARITY_KW = dict(maximum_iteration=250, enable_warm_start=True)
NLMPC_PARITY_KW = dict(maximum_iteration=100, hessian_reg="eigh", enable_warm_start=True)


def stats_row(s):
    return np.array([float(getattr(s, f)) for f in STATS_FIELDS])


# -- the rank worker (torch only) ----------------------------------------------
def _quad(lt, **kw):
    import chip_smoke

    return chip_smoke.quadrotor_controller(
        lt, torch.float64, "cpu", lt.LParameters(**{"maximum_iteration": 250, **kw}))


def _vdp(lt, **kw):
    import chip_smoke

    return chip_smoke.vdp_controller(
        lt, torch.float64, "cpu", lt.NLParameters(**{"maximum_iteration": 100, **kw}))


def _s_mesh(lt, par, mesh, out, args):
    out["mesh_shape"] = np.array([mesh.shape["data"], mesh.shape["model"], mesh.rank])
    m2 = par.make_mesh(model=2, device="cpu")
    out["mesh_model2"] = np.array([m2.shape["data"], m2.shape["model"], m2.data_index,
                                   m2.model_index, m2.rows(8).start])
    try:
        par.make_mesh(data=3, device="cpu")
        out["mesh_data3_refused"] = np.array(False)
    except ValueError:
        out["mesh_data3_refused"] = np.array(True)
    got = par.shard_batch(mesh, {"x": np.arange(16), "t": torch.arange(8)})
    out["shard_x"], out["shard_t"] = got["x"], got["t"].numpy()


def _s_lmpc_parity(lt, par, mesh, out, args):
    from libmpc_tpu_torch.utils import checkpoint

    steps = lmpc_parity_inputs()
    fleet = par.LMPCFleet(_quad(lt, **LMPC_PARITY_KW), mesh)
    cmds, status, stats = [], [], []
    for k, (x, u) in enumerate(steps):
        r, s = fleet.optimize(x, u)
        cmds.append(r.cmd.numpy())
        status.append(r.status.numpy())
        stats.append(stats_row(s))
        if k == 0:
            checkpoint.save_fleet(fleet, str(Path(args.out) / "port_lmpc.npz"))
    out["lmpc_cmd"], out["lmpc_status"] = np.stack(cmds), np.stack(status)
    out["lmpc_stats"] = np.stack(stats)
    x1, u1 = steps[1]
    for key, path in (("lmpc_resumed", Path(args.out) / "port_lmpc.npz"),
                      ("lmpc_from_jax", Path(args.jax_dir) / "jax_lmpc.npz")):
        f2 = par.LMPCFleet(_quad(lt, **LMPC_PARITY_KW), mesh)
        checkpoint.load_fleet(f2, str(path))
        out[key] = f2.optimize(x1, u1)[0].cmd.numpy()


def _s_nlmpc_parity(lt, par, mesh, out, args):
    from libmpc_tpu_torch.utils import checkpoint

    steps = nlmpc_parity_inputs()
    fleet = par.NLMPCFleet(_vdp(lt, **NLMPC_PARITY_KW), mesh)
    cmds, status, stats, iters = [], [], [], []
    for k, (x, u) in enumerate(steps):
        r, s = fleet.optimize(x, u)
        cmds.append(r.cmd.numpy())
        status.append(r.status.numpy())
        stats.append(stats_row(s))
        iters.append(fleet._last_iters.numpy())
        if k == 0:
            checkpoint.save_fleet(fleet, str(Path(args.out) / "port_nlmpc.npz"))
    out["nlmpc_cmd"], out["nlmpc_status"] = np.stack(cmds), np.stack(status)
    out["nlmpc_stats"], out["nlmpc_local_iters"] = np.stack(stats), np.stack(iters)
    x1, u1 = steps[1]
    for key, path in (("nlmpc_resumed", Path(args.out) / "port_nlmpc.npz"),
                      ("nlmpc_from_jax", Path(args.jax_dir) / "jax_nlmpc.npz")):
        f2 = par.NLMPCFleet(_vdp(lt, **NLMPC_PARITY_KW), mesh)
        checkpoint.load_fleet(f2, str(path))
        out[key] = f2.optimize(x1, u1)[0].cmd.numpy()


def _s_lmpc_unsharded(lt, par, mesh, out, args):
    c = _quad(lt)
    rng = np.random.default_rng(0)
    x0, u0 = 0.05 * rng.normal(size=(16, 12)), np.zeros((16, 4))
    r, s = par.LMPCFleet(c, mesh).optimize(x0, u0)
    out["lmpc_unsharded_fleet"], out["lmpc_unsharded_stats"] = r.cmd.numpy(), stats_row(s)
    out["lmpc_unsharded_plain"] = c.optimize(x0, u0).cmd.numpy()


def _s_batched_refs(lt, par, mesh, out, args):
    y_ref = np.zeros((8, 10, 12))
    y_ref[:, :, 2] = np.linspace(0.5, 1.5, 8)[:, None]
    r, s = par.LMPCFleet(_quad(lt), mesh).optimize(np.zeros((8, 12)), np.zeros((8, 4)),
                                                   y_ref=y_ref)
    out["refs_cmd"], out["refs_stats"] = r.cmd.numpy(), stats_row(s)


def _s_closed_loop(lt, par, mesh, out, args):
    Ad, Bd = quadrotor_model()
    fleet = par.LMPCFleet(_quad(lt), mesh)
    x, u = 0.02 * np.random.default_rng(1).normal(size=(8, 12)), np.zeros((8, 4))
    for _ in range(40):
        u = fleet.optimize(x, u)[0].cmd.numpy()
        x = x @ Ad.T + u @ Bd.T
    out["loop_x"] = x


def _s_uneven(lt, par, mesh, out, args):
    for key, fleet, shapes in (
            ("uneven_lmpc", par.LMPCFleet(_quad(lt), mesh), ((3, 12), (3, 4))),
            ("uneven_nlmpc", par.NLMPCFleet(_vdp(lt), mesh), ((6, 2), (6, 1)))):
        try:
            fleet.optimize(np.zeros(shapes[0]), np.zeros(shapes[1]))
            out[key] = np.array(False)
        except ValueError:
            out[key] = np.array(True)


def _s_hold(lt, par, mesh, out, args):
    rng = np.random.default_rng(5)
    fleet = par.LMPCFleet(_quad(lt), mesh)
    x, u = 0.02 * rng.normal(size=(8, 12)), np.zeros((8, 4))
    r = fleet.optimize(x, u)[0]
    x_bad = x.copy()
    x_bad[3] = np.nan
    r2 = fleet.optimize(x_bad, r.cmd.numpy())[0]
    out["hold_lmpc"] = np.stack([r.cmd.numpy(), r2.cmd.numpy()])
    out["hold_lmpc_status"] = r2.status.numpy()

    rng = np.random.default_rng(6)
    fleet = par.NLMPCFleet(_vdp(lt), mesh)
    x, u = rng.uniform(-0.5, 0.5, size=(8, 2)), np.zeros((8, 1))
    r = fleet.optimize(x, u)[0]
    x_bad = x.copy()
    x_bad[5] = np.nan
    r2 = fleet.optimize(x_bad, r.cmd.numpy())[0]
    out["hold_nlmpc"] = np.stack([r.cmd.numpy(), r2.cmd.numpy()])
    out["hold_nlmpc_status"] = r2.status.numpy()


def _s_nlmpc_unsharded(lt, par, mesh, out, args):
    rng = np.random.default_rng(2)
    x0, u0 = rng.uniform(-1, 1, size=(8, 2)), np.zeros((8, 1))
    for key, kw in (("eigh", dict(hessian_reg="eigh")), ("gershgorin", {})):
        c = _vdp(lt, **kw)
        r, s = par.NLMPCFleet(c, mesh).optimize(x0, u0)
        out[f"nl_{key}_fleet"], out[f"nl_{key}_stats"] = r.cmd.numpy(), stats_row(s)
        out[f"nl_{key}_plain"] = c.optimize(x0, u0).cmd.numpy()
    _, s = par.NLMPCFleet(_vdp(lt), mesh).optimize(np.zeros((8, 2)), np.zeros((8, 1)))
    out["stats_str"] = np.array(str(s))


def _s_cold_restart(lt, par, mesh, out, args):
    fleet = par.NLMPCFleet(_vdp(lt, hessian_reg="eigh", enable_warm_start=True,
                                cold_restart_on_failure=True), mesh)
    rng = np.random.default_rng(4)
    x, u = rng.uniform(-1, 1, size=(8, 2)), np.zeros((8, 1))
    statuses = []
    for _ in range(3):
        r = fleet.optimize(x, u)[0]
        statuses.append(r.status.numpy())
        u = r.cmd.numpy()
        x = x + 0.1 * rng.normal(size=x.shape) * 0.01
    out["cold_status"] = np.stack(statuses)


def _s_runtime_caps(lt, par, mesh, out, args):
    c = _vdp(lt)
    assert c.set_ineq_con_function(lambda X, Y, U, e, p: U[:, 0] - p["cap"])
    caps = np.linspace(0.01, 0.2, 8)
    c.set_runtime_params({"cap": torch.as_tensor(caps)}, batched=True)
    r, s = par.NLMPCFleet(c, mesh).optimize(np.tile([[0.0, 1.0]], (8, 1)), np.zeros((8, 1)))
    out["caps"], out["caps_cmd"], out["caps_stats"] = caps, r.cmd.numpy()[:, 0], stats_row(s)


def _s_unknown_bucket(lt, par, mesh, out, args):
    from libmpc_tpu_torch.parallel.fleet import _local_stats

    status = torch.tensor([0, 0, 1, 2, 3, 4, 4, 4], dtype=torch.int32)
    iters = torch.full((8,), 5, dtype=torch.int32)
    rows = mesh.rows(8)
    s, _ = _local_stats(status[rows], iters[rows], mesh)
    out["unknown_stats"], out["unknown_str"] = stats_row(s), np.array(str(s))


def _s_compaction(lt, par, mesh, out, args):
    rng = np.random.default_rng(1)
    B = 1024
    x0, u0 = 0.02 * rng.normal(size=(B, 12)), np.zeros((B, 4))
    for on in (True, False):
        c = _quad(lt, maximum_iteration=60, enable_warm_start=True, compact_stragglers=on)
        r, s = par.LMPCFleet(c, mesh).optimize(x0, u0)
        out[f"compact_{on}"], out[f"compact_{on}_stats"] = r.cmd.numpy(), stats_row(s)


def _s_golden(lt, par, mesh, out, args):
    r, s = par.LMPCFleet(_quad(lt), mesh).optimize(np.zeros((8, 12)), np.zeros((8, 4)))
    out["golden_cmd"], out["golden_stats"] = r.cmd.numpy(), stats_row(s)


SCENARIOS = (_s_mesh, _s_lmpc_parity, _s_nlmpc_parity, _s_lmpc_unsharded, _s_batched_refs,
             _s_closed_loop, _s_uneven, _s_hold, _s_nlmpc_unsharded, _s_cold_restart,
             _s_runtime_caps, _s_unknown_bucket, _s_compaction, _s_golden)


def rank_main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one gloo rank of the fleet tests")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--init", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--jax-dir", required=True)
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    sys.path.insert(0, str(ROOT))
    import libmpc_tpu_torch as lt
    from libmpc_tpu_torch import parallel as par

    par.init_distributed(args.init, args.world, args.rank, backend="gloo",
                         timeout=COLLECTIVE_TIMEOUT_S)
    mesh = par.make_mesh(device="cpu")
    out = {}
    for scenario in SCENARIOS:
        t0 = time.perf_counter()
        scenario(lt, par, mesh, out, args)
        print(f"[rank {args.rank}] {scenario.__name__} {time.perf_counter() - t0:.2f}s",
              flush=True)
    torch.distributed.destroy_process_group()
    out["foreign_modules"] = np.array(
        [m for m in sys.modules if m == "jax" or m.startswith("jax.")
         or m == "libmpc_tpu" or m.startswith("libmpc_tpu.")], dtype=str)
    np.savez(Path(args.out) / f"rank{args.rank}.npz", **out)
    return 0


# -- the JAX reference and the spawn ------------------------------------------
@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    """The JAX package's fleets over the parity inputs (LMPC on four devices,
    as the ranks split it; NLMPC on eight, one lane a device); their
    checkpoints after the first step are written for the ranks to load."""
    import jax.numpy as jnp

    import libmpc_tpu as lj
    from libmpc_tpu.parallel import mesh as jmesh
    from libmpc_tpu.parallel.fleet import LMPCFleet, NLMPCFleet
    from libmpc_tpu.utils import checkpoint as jck
    from test_lmpc import make_quadrotor_controller
    from test_nlmpc import make_vdp_controller

    d = tmp_path_factory.mktemp("jax_fleet")
    mesh = jmesh.make_mesh(data=WORLD)
    ref = {"dir": d}
    c = make_quadrotor_controller()
    c.set_optimizer_parameters(lj.LParameters(**LMPC_PARITY_KW))
    fl = LMPCFleet(c, mesh)
    cmds, status, stats = [], [], []
    for k, (x, u) in enumerate(lmpc_parity_inputs()):
        r, s = fl.optimize(x, u)
        cmds.append(np.asarray(r.cmd))
        status.append(np.asarray(r.status))
        stats.append(stats_row(s))
        if k == 0:
            jck.save_fleet(fl, str(d / "jax_lmpc.npz"))
    ref.update(lmpc=fl, lmpc_cmd=np.stack(cmds), lmpc_status=np.stack(status),
               lmpc_stats=np.stack(stats))

    # one lane a device: at two or more lanes a device the JAX package's
    # vmapped SQP (eigh curvature, float64, dense interior point) departs
    # from its own one-lane solves (lane 3 of step 1: 8 SQP iterations
    # against 4, commands 1.7e-7 apart; lane 0 of step 2: 4.8e-5 apart),
    # while the port gives the one-lane result at every batch size
    params = lj.NLParameters(**NLMPC_PARITY_KW)
    c = make_vdp_controller()
    c.set_optimizer_parameters(params)
    fn = NLMPCFleet(c, jmesh.make_mesh(data=8))
    cmds, status, stats = [], [], []
    for k, (x, u) in enumerate(nlmpc_parity_inputs()):
        r, s = fn.optimize(x, u)
        cmds.append(np.asarray(r.cmd))
        status.append(np.asarray(r.status))
        stats.append(stats_row(s))
        if k == 0:
            jck.save_fleet(fn, str(d / "jax_nlmpc.npz"))
    # each lane's SQP iterations: its own unbatched chain of solves
    plain = make_vdp_controller()
    plain.set_optimizer_parameters(params)
    iters = np.zeros((2, 8), int)
    for i in range(8):
        plain._opt_vector, plain._current_slack = None, 0.0
        for k, (x, u) in enumerate(nlmpc_parity_inputs()):
            plain.optimize(jnp.asarray(x[i]), jnp.asarray(u[i]))
            iters[k, i] = int(plain._last_iters)
    ref.update(nlmpc=fn, nlmpc_cmd=np.stack(cmds), nlmpc_status=np.stack(status),
               nlmpc_stats=np.stack(stats), nlmpc_iters=iters)
    return ref


@pytest.fixture(scope="module")
def ranks(jax_ref, tmp_path_factory):
    """Every rank's record of every scenario (rank -> npz)."""
    d = tmp_path_factory.mktemp("fleet_ranks")
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")]))
    for var in ("XLA_FLAGS", "WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(var, None)
    procs, logs = [], []
    for r in range(WORLD):
        log = open(d / f"rank{r}.log", "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, __file__, "--rank", str(r), "--world", str(WORLD),
             "--init", f"file://{d / 'store'}", "--out", str(d),
             "--jax-dir", str(jax_ref["dir"])],
            cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT))
    end = time.monotonic() + SPAWN_TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(1.0, end - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    rcs = [p.returncode for p in procs]
    if any(rcs):
        tails = "\n".join(f"--- rank {r} (rc {rc}) ---\n"
                          + (d / f"rank{r}.log").read_text()[-3000:]
                          for r, rc in enumerate(rcs))
        pytest.fail(f"rank processes failed: {rcs}\n{tails}")
    out = {r: dict(np.load(d / f"rank{r}.npz")) for r in range(WORLD)}
    out["dir"] = d
    return out


def every_rank(ranks, key):
    return [ranks[r][key] for r in range(WORLD)]


# -- the mesh -------------------------------------------------------------------
def test_mesh_shape_and_refusals(ranks):
    """model=2 over four ranks builds the (2, 2) mesh (rank r at data index
    r // 2, model index r % 2); data=3 is not the world and raises."""
    for r in range(WORLD):
        assert list(ranks[r]["mesh_shape"]) == [WORLD, 1, r]
        assert list(ranks[r]["mesh_model2"]) == [2, 2, r // 2, r % 2, 4 * (r // 2)]
        assert ranks[r]["mesh_data3_refused"]


def test_shard_batch_takes_the_ranks_contiguous_rows(ranks):
    for r in range(WORLD):
        assert np.array_equal(ranks[r]["shard_x"], np.arange(4 * r, 4 * r + 4))
        assert np.array_equal(ranks[r]["shard_t"], np.arange(2 * r, 2 * r + 2))


def test_rank_processes_import_neither_jax_nor_the_jax_package(ranks):
    for r in range(WORLD):
        assert ranks[r]["foreign_modules"].size == 0, ranks[r]["foreign_modules"]


def test_one_process_mesh_without_a_process_group(monkeypatch):
    import torch.distributed as dist

    from libmpc_tpu_torch.parallel import mesh as tmesh

    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    tmesh.init_distributed()  # one process, nothing asked: no process group
    assert not dist.is_initialized()
    m = tmesh.make_mesh(device="cpu")
    assert m.shape == {"data": 1, "model": 1} and m.backend is None and m.rank == 0
    # one rank: model=2 makes a 0 x 2 mesh, which is not the world
    with pytest.raises(ValueError, match="needs"):
        tmesh.make_mesh(model=2, device="cpu")
    assert tmesh.make_mesh(1, 1, device="cpu").shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError):
        tmesh.make_mesh(data=2, device="cpu")
    with pytest.raises(ValueError):
        tmesh.Mesh({"data": 4, "model": 1}, 0, m.device, None).rows(6)
    assert tmesh.pad_to_multiple(10, 4) == 12 and tmesh.pad_to_multiple(12, 4) == 12


# -- parity with the JAX package's fleets --------------------------------------
def test_lmpc_fleet_matches_jax_fleet(ranks, jax_ref):
    for r in range(WORLD):
        got = ranks[r]
        assert np.abs(got["lmpc_cmd"] - jax_ref["lmpc_cmd"]).max() <= 1e-8
        assert np.array_equal(got["lmpc_status"], jax_ref["lmpc_status"])
        # counts exact; the mean as the JAX package's float32 rounds it
        assert np.array_equal(got["lmpc_stats"][:, [0, 1, 2, 3, 4, 5, 7]],
                              jax_ref["lmpc_stats"][:, [0, 1, 2, 3, 4, 5, 7]])
        assert np.array_equal(got["lmpc_stats"][:, 6].astype(np.float32),
                              jax_ref["lmpc_stats"][:, 6].astype(np.float32))


def test_nlmpc_fleet_matches_jax_fleet(ranks, jax_ref):
    iters = np.concatenate([ranks[r]["nlmpc_local_iters"] for r in range(WORLD)], axis=1)
    assert np.array_equal(iters, jax_ref["nlmpc_iters"])
    for r in range(WORLD):
        got = ranks[r]
        assert np.abs(got["nlmpc_cmd"] - jax_ref["nlmpc_cmd"]).max() <= 1e-8
        assert np.array_equal(got["nlmpc_status"], jax_ref["nlmpc_status"])
        assert np.array_equal(got["nlmpc_stats"][:, [0, 1, 2, 3, 4, 5, 7]],
                              jax_ref["nlmpc_stats"][:, [0, 1, 2, 3, 4, 5, 7]])
        assert np.array_equal(got["nlmpc_stats"][:, 6].astype(np.float32),
                              jax_ref["nlmpc_stats"][:, 6].astype(np.float32))


# -- the cases of tests/test_parallel.py ---------------------------------------
def test_lmpc_sharded_matches_unsharded(ranks):
    for got in every_rank(ranks, "lmpc_unsharded_fleet"):
        assert np.allclose(got, ranks[0]["lmpc_unsharded_plain"], atol=1e-8)
    for s in every_rank(ranks, "lmpc_unsharded_stats"):
        assert s[0] == 16 and s[1] == 16


def test_batched_references(ranks):
    for r in range(WORLD):
        thrust = ranks[r]["refs_cmd"].sum(axis=1)
        assert np.all(np.diff(thrust) > 0)
        assert ranks[r]["refs_stats"][1] == 8


def test_fleet_closed_loop(ranks):
    for x in every_rank(ranks, "loop_x"):
        assert np.all(np.abs(x[:, 2] - 1.0) < 5e-2)


def test_uneven_batch_raises_on_every_rank(ranks):
    for r in range(WORLD):
        assert ranks[r]["uneven_lmpc"] and ranks[r]["uneven_nlmpc"]


def test_nlmpc_sharded_matches_unsharded(ranks):
    for r in range(WORLD):
        assert np.allclose(ranks[r]["nl_eigh_fleet"], ranks[r]["nl_eigh_plain"], atol=1e-8)
        assert ranks[r]["nl_eigh_stats"][0] == 8 and ranks[r]["nl_eigh_stats"][6] > 0


def test_nlmpc_sharded_matches_unsharded_default_mode(ranks):
    for r in range(WORLD):
        assert ranks[r]["nl_gershgorin_stats"][1] == 8
        assert np.allclose(ranks[r]["nl_gershgorin_fleet"], ranks[r]["nl_gershgorin_plain"],
                           atol=2e-4)


def test_stats_str(ranks):
    for r in range(WORLD):
        text = str(ranks[r]["stats_str"])
        assert "SUCCESS" in text and "instances: 8" in text


def test_cold_restart_knob_runs_sharded(ranks):
    for s in every_rank(ranks, "cold_status"):
        assert (s == 0).all()


def test_lmpc_fleet_holds_last_command(ranks):
    for r in range(WORLD):
        good, cmd2 = ranks[r]["hold_lmpc"]
        status = ranks[r]["hold_lmpc_status"]
        assert np.all(np.isfinite(good))
        assert np.allclose(cmd2[3], good[3], atol=1e-12)
        assert status[3] == 3  # ResultStatus.ERROR
        ok = [i for i in range(8) if i != 3]
        assert np.all(np.isfinite(cmd2[ok])) and np.all(status[ok] == 0)


def test_nlmpc_fleet_holds_last_command(ranks):
    for r in range(WORLD):
        good, cmd2 = ranks[r]["hold_nlmpc"]
        assert np.all(np.isfinite(good))
        assert np.allclose(cmd2[5], good[5], atol=1e-12)
        assert ranks[r]["hold_nlmpc_status"][5] == 3
        assert np.all(np.isfinite(cmd2[[i for i in range(8) if i != 5]]))


def test_nlmpc_fleet_batched_params(ranks):
    for r in range(WORLD):
        caps, cmds = ranks[r]["caps"], ranks[r]["caps_cmd"]
        assert np.all(cmds <= caps + 1e-6)
        assert abs(cmds[0] - 0.01) < 1e-6
        assert cmds[-1] < 0.2 - 1e-3
        assert ranks[r]["caps_stats"][0] == 8


def test_unknown_bucket_counted_across_ranks(ranks):
    for r in range(WORLD):
        s = ranks[r]["unknown_stats"]
        assert s[5] == 3
        assert s[1:6].sum() == s[0] == 8
        assert "UNKNOWN" in str(ranks[r]["unknown_str"])


def test_shard_level_compaction_is_invisible(ranks):
    """256 instances a rank: each rank's ADMM compacts its stragglers; on
    and off agree to rounding, as in the JAX package."""
    for r in range(WORLD):
        assert ranks[r]["compact_True_stats"][1] == 1024
        assert ranks[r]["compact_False_stats"][1] == 1024
        assert np.allclose(ranks[r]["compact_True"], ranks[r]["compact_False"], atol=1e-9)


def test_cross_process_golden_on_every_rank(ranks):
    """tests/test_multihost.py's check: every rank's shard reproduces the
    golden quadrotor command, and every rank sees the global stats."""
    for r in range(WORLD):
        shard = ranks[r]["golden_cmd"][2 * r:2 * r + 2]
        assert np.allclose(shard, GOLDEN_CMD, atol=1e-4)
        assert np.allclose(ranks[r]["golden_cmd"], GOLDEN_CMD, atol=1e-4)
        assert ranks[r]["golden_stats"][0] == 8 and ranks[r]["golden_stats"][1] == 8


# -- checkpoints ----------------------------------------------------------------
@pytest.mark.parametrize("kind", ["lmpc", "nlmpc"])
def test_fleet_checkpoint_resumes_bitwise(ranks, kind):
    for r in range(WORLD):
        assert np.array_equal(ranks[r][f"{kind}_resumed"], ranks[r][f"{kind}_cmd"][1])


@pytest.mark.parametrize("kind", ["lmpc", "nlmpc"])
def test_jax_fleet_file_loads_into_the_port(ranks, jax_ref, kind):
    for r in range(WORLD):
        assert np.abs(ranks[r][f"{kind}_from_jax"] - jax_ref[f"{kind}_cmd"][1]).max() <= 1e-8


@pytest.mark.parametrize("kind", ["lmpc", "nlmpc"])
def test_port_fleet_file_loads_into_jax(ranks, jax_ref, kind):
    from libmpc_tpu.utils import checkpoint as jck

    fleet = jax_ref[kind]
    jck.load_fleet(fleet, str(ranks["dir"] / f"port_{kind}.npz"))
    x1, u1 = (lmpc_parity_inputs if kind == "lmpc" else nlmpc_parity_inputs)()[1]
    r, _ = fleet.optimize(x1, u1)
    assert np.abs(np.asarray(r.cmd) - ranks[0][f"{kind}_cmd"][1]).max() <= 1e-8


# -- one rank, no process group ---------------------------------------------------
def test_one_rank_fleet_is_the_controller_bitwise():
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    import libmpc_tpu_torch as lt
    from libmpc_tpu_torch import parallel as par

    mesh = par.make_mesh(device="cpu")
    Ad, Bd = chip_smoke.quadrotor_model()
    fleet = par.LMPCFleet(_quad(lt, **LMPC_PARITY_KW), mesh)
    plain = _quad(lt, **LMPC_PARITY_KW)
    x, u = 0.05 * np.random.default_rng(3).normal(size=(6, 12)), np.zeros((6, 4))
    for _ in range(3):
        r, s = fleet.optimize(x, u)
        p = plain.optimize(x, u)
        assert torch.equal(r.cmd, p.cmd) and torch.equal(r.status, p.status)
        assert torch.equal(fleet._last_iters, plain._last_iters)
        assert s.n_total == 6 and s.n_success == int((p.status == 0).sum())
        u = r.cmd.numpy()
        x = x @ Ad.T + u @ Bd.T

    fleet = par.NLMPCFleet(_vdp(lt, **NLMPC_PARITY_KW), mesh)
    plain = _vdp(lt, **NLMPC_PARITY_KW)
    x, u = np.random.default_rng(3).uniform(-1, 1, size=(4, 2)), np.zeros((4, 1))
    for _ in range(3):
        r, s = fleet.optimize(x, u)
        p = plain.optimize(x, u)
        assert torch.equal(r.cmd, p.cmd) and torch.equal(r.status, p.status)
        assert torch.equal(fleet._last_iters, plain._last_iters)
        u = r.cmd.numpy()
        x = vdp_step(x, u)


if __name__ == "__main__":
    sys.exit(rank_main())
