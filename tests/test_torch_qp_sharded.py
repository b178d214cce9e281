"""The port's row-sharded QP (``libmpc_tpu_torch/parallel/qp_sharded.py``)
and its ``(data, model)`` mesh over ``torch.distributed`` on CPU gloo ranks.

The module fixture spawns this file as eight rank processes
(``python tests/test_torch_qp_sharded.py --rank r ...``), once for the
module.  Each rank imports only torch, numpy, the port and
``chip_smoke.py``'s quadrotor setup (neither JAX nor the JAX package),
joins a gloo process group through a file store with a 60 s collective
timeout, runs every scenario below in the same order and writes what it saw
to ``rank<r>.npz``; each test asserts on those files.  While the ranks run,
the parent computes the references from the same numpy inputs: the JAX
package's ``solve_sharded`` on the conftest's eight-device virtual mesh of
the same shape, and its unsharded ``admm_solve``.

The cases are those of ``tests/test_qp_sharded.py``, each also held to the
JAX package's ``solve_sharded`` in float64: statuses and iteration counts
equal, x and y within 1e-8.  On top: the mesh's layout and groups, the
refusal of a shape that is not the world, every rank's copy of the global
solution, the KKT cold-start seed (reduced over the row shards in the port,
a shard's partial sum in the JAX package), and an ``LMPCFleet`` on a
(4, 2) mesh.
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
WORLD = 8
COLLECTIVE_TIMEOUT_S = 60
SPAWN_TIMEOUT_S = 300
GOLDEN_CMD = np.array([-0.9916, 1.74839, -0.9916, 1.74839])
MESHES = ((4, 2), (2, 4), (1, 8))
PARITY_TOL = 1e-8

# the settings of tests/test_qp_sharded.py
PAR_KW = dict(maximum_iteration=4000, eps_abs=1e-8, eps_rel=1e-8, rho=0.1,
              adaptive_rho=False, scaling_iters=0, polish=False)
FULL_KW = dict(maximum_iteration=4000, eps_abs=1e-8, eps_rel=1e-8, rho=0.1,
               adaptive_rho=True, scaling_iters=10, polish=True)
INFEAS_KW = dict(maximum_iteration=4000, eps_abs=1e-8, eps_rel=1e-8, rho=0.1)
KKT_KW = dict(PAR_KW, cold_start="kkt")


# -- inputs shared by both packages (numpy only) -------------------------------
def random_qp(rng, n, m, batch=None):
    """A copy of tests/test_admm.py::random_qp (that module imports JAX,
    which the ranks may not)."""
    L = rng.normal(size=(n, n))
    P = L @ L.T + 0.1 * np.eye(n)
    A = rng.normal(size=(m, n))
    shape = (batch, ) if batch else ()
    q = rng.normal(size=shape + (n,))
    x_hat = rng.normal(size=shape + (n,))
    zc = x_hat @ A.T
    width = rng.uniform(0.1, 1.0, size=shape + (m,))
    return P, A, q, zc - width, zc + width


def random_case():
    return random_qp(np.random.default_rng(0), 10, 17, batch=8)  # 17 rows: padding hit


def badly_scaled_case():
    """1e4 dynamic range on rows and columns (needs Ruiz, adaptive rho and
    polish)."""
    rng = np.random.default_rng(5)
    n, m, B = 12, 21, 8
    P, A, q, l, u = random_qp(rng, n, m, batch=B)
    row_s = 10.0 ** rng.uniform(-2, 2, size=(m, 1))
    col_s = 10.0 ** rng.uniform(-2, 2, size=(1, n))
    A = row_s * A * col_s
    P = col_s.T * P * col_s
    return P, A, q, l * row_s[:, 0], u * row_s[:, 0]


def infeasible_case():
    """Contradictory rows: a x <= -1 and a x >= 1."""
    rng = np.random.default_rng(6)
    n, m, B = 6, 10, 4
    P, A, q, _, _ = random_qp(rng, n, m, batch=B)
    A[1] = A[0]
    l = np.full((B, m), -np.inf)
    u = np.full((B, m), np.inf)
    u[:, 0] = -1.0
    l[:, 1] = 1.0
    return P, A, q, l, u


def uneven_case():
    return random_qp(np.random.default_rng(1), 6, 9, batch=3)


QUAD_B = 4


def kkt_error(P, A, q, l, u, x, y):
    """Max violation of stationarity, feasibility and complementarity (as
    tests/test_admm.py::kkt_error)."""
    stat = np.abs(x @ P + q + y @ A).max()
    z = x @ A.T
    pfeas = np.maximum(z - u, 0).max() + np.maximum(l - z, 0).max()
    comp = np.abs(y * np.where(y > 0, z - u, z - l)).max()
    return max(stat, pfeas, comp)


SOLUTION_FIELDS = ("x", "y", "status", "iters", "obj_val", "pri_res", "dua_res")


# -- the rank worker (torch only) ----------------------------------------------
def _record(out, key, sol):
    for f in SOLUTION_FIELDS:
        out[f"{key}.{f}"] = getattr(sol, f).numpy()


def _s_mesh(lt, par, meshes, out):
    from libmpc_tpu_torch.parallel import mesh as mesh_lib

    for (d, m), mesh in meshes.items():
        key = f"mesh{d}x{m}"
        out[f"{key}.place"] = np.array([mesh.rank, mesh.data_index, mesh.model_index,
                                        mesh.rows(8).start, mesh.shape["data"],
                                        mesh.shape["model"]])
        me = torch.tensor([[mesh.rank]])
        for axis in ("data", "model"):
            out[f"{key}.{axis}"] = mesh_lib.all_gather_rows(mesh, me, axis)[:, 0].numpy()
            out[f"{key}.{axis}_sum"] = mesh.axis(axis).sum(me.double()).numpy()
        out[f"{key}.all_max"] = mesh.axis(None).max(me.double()).numpy()
    for key, kw in (("refuse_3x2", dict(data=3, model=2)), ("refuse_model3", dict(model=3)),
                    ("refuse_2x2", dict(data=2, model=2)), ("refuse_model0", dict(model=0))):
        try:
            par.make_mesh(device="cpu", **kw)
            out[key] = np.array(False)
        except ValueError:
            out[key] = np.array(True)


def _s_random(lt, par, meshes, out):
    P, A, q, l, u = random_case()
    for (d, m) in MESHES:
        _record(out, f"random{d}x{m}",
                par.solve_sharded(P, A, q, l, u, meshes[d, m], lt.LParameters(**PAR_KW)))


def _s_features(lt, par, meshes, out):
    _record(out, "badly_scaled", par.solve_sharded(*badly_scaled_case(), meshes[2, 4],
                                                   lt.LParameters(**FULL_KW)))
    _record(out, "infeasible", par.solve_sharded(*infeasible_case(), meshes[2, 4],
                                                 lt.LParameters(**INFEAS_KW)))
    try:
        par.solve_sharded(*uneven_case(), meshes[2, 4], lt.LParameters(**PAR_KW))
        out["uneven_raised"] = np.array(False)
    except ValueError:
        out["uneven_raised"] = np.array(True)


def _s_warm(lt, par, meshes, out):
    """The primal-only and the full warm start from the cold solve on (4, 2)
    (``random4x2``), and the KKT cold-start seed."""
    P, A, q, l, u = random_case()
    mesh, params = meshes[4, 2], lt.LParameters(**PAR_KW)
    x, y = (torch.as_tensor(out[f"random4x2.{f}"]) for f in ("x", "y"))
    _record(out, "warm_x", par.solve_sharded(P, A, q, l, u, mesh, params, warm_x=x))
    _record(out, "warm_xy", par.solve_sharded(P, A, q, l, u, mesh, params, warm_x=x, warm_y=y))
    _record(out, "kkt", par.solve_sharded(P, A, q, l, u, mesh, lt.LParameters(**KKT_KW)))


def _s_quadrotor(lt, par, meshes, out):
    import chip_smoke

    P, A, q, l, u, eq, cmd = chip_smoke.quadrotor_qp(
        torch, lt, torch.float64, "cpu", np.zeros((QUAD_B, 12)), np.zeros((QUAD_B, 4)))
    sol = par.solve_sharded(P, A, q, l, u, meshes[2, 4], lt.LParameters(**PAR_KW), eq_mask=eq)
    _record(out, "quadrotor", sol)
    out["quadrotor.cmd"] = cmd(sol.x).numpy()


def _s_fleet(lt, par, meshes, out):
    """An LMPCFleet on (4, 2): each data index's two model replicas solve the
    same rows; against the plain controller on each data index's rows."""
    import chip_smoke

    make = lambda: chip_smoke.quadrotor_controller(
        lt, torch.float64, "cpu", lt.LParameters(maximum_iteration=250))
    rng = np.random.default_rng(0)
    x0, u0 = 0.05 * rng.normal(size=(8, 12)), np.zeros((8, 4))
    r, s = par.LMPCFleet(make(), meshes[4, 2]).optimize(x0, u0)
    out["fleet.cmd"], out["fleet.status"] = r.cmd.numpy(), r.status.numpy()
    out["fleet.stats"] = np.array([float(getattr(s, f)) for f in (
        "n_total", "n_success", "n_max_iteration", "n_infeasible", "n_error", "n_unknown",
        "mean_iterations", "max_iterations")])
    cmds, status, iters = [], [], []
    for d in range(4):
        c = make()
        p = c.optimize(x0[2 * d:2 * d + 2], u0[2 * d:2 * d + 2])
        cmds.append(p.cmd.numpy())
        status.append(p.status.numpy())
        iters.append(c._last_iters.numpy())
    out["fleet.plain_cmd"], out["fleet.plain_status"] = np.concatenate(cmds), np.concatenate(status)
    out["fleet.plain_iters"] = np.concatenate(iters)


SCENARIOS = (_s_mesh, _s_random, _s_features, _s_warm, _s_quadrotor, _s_fleet)


def rank_main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one gloo rank of the row-sharded QP tests")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--init", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    sys.path.insert(0, str(ROOT))
    import libmpc_tpu_torch as lt
    from libmpc_tpu_torch import parallel as par

    par.init_distributed(args.init, args.world, args.rank, backend="gloo",
                         timeout=COLLECTIVE_TIMEOUT_S)
    meshes = {(d, m): par.make_mesh(d, m, device="cpu") for d, m in MESHES}
    out = {}
    for scenario in SCENARIOS:
        t0 = time.perf_counter()
        scenario(lt, par, meshes, out)
        print(f"[rank {args.rank}] {scenario.__name__} {time.perf_counter() - t0:.2f}s",
              flush=True)
    torch.distributed.destroy_process_group()
    out["foreign_modules"] = np.array(
        [m for m in sys.modules if m == "jax" or m.startswith("jax.")
         or m == "libmpc_tpu" or m.startswith("libmpc_tpu.")], dtype=str)
    np.savez(Path(args.out) / f"rank{args.rank}.npz", **out)
    return 0


# -- the JAX references and the spawn -----------------------------------------
def jax_references():
    """The JAX package's solve_sharded (on a virtual mesh of each case's
    shape) and unsharded admm_solve over the same inputs, as numpy."""
    import jax.numpy as jnp

    import libmpc_tpu as lj
    from libmpc_tpu.lmpc import problem as jqp
    from libmpc_tpu.ops import admm as jadmm
    from libmpc_tpu.parallel import mesh as jmesh
    from libmpc_tpu.parallel.qp_sharded import solve_sharded as jsolve
    from test_lmpc import make_quadrotor_controller

    def rec(sol):
        return {f: np.asarray(getattr(sol, f)) for f in SOLUTION_FIELDS}

    ref = {}
    j = lambda arrays: tuple(map(jnp.asarray, arrays))
    par, full = lj.LParameters(**PAR_KW), lj.LParameters(**FULL_KW)
    rnd = j(random_case())
    for (d, m) in MESHES:
        ref[f"random{d}x{m}"] = rec(jsolve(*rnd, jmesh.make_mesh(data=d, model=m), par))
    ref["random.unsharded"] = rec(jadmm.admm_solve(*rnd, par))
    bad = j(badly_scaled_case())
    ref["badly_scaled"] = rec(jsolve(*bad, jmesh.make_mesh(data=2, model=4), full))
    ref["badly_scaled.unsharded"] = rec(jadmm.admm_solve(*bad, full))
    ref["infeasible"] = rec(jsolve(*j(infeasible_case()), jmesh.make_mesh(data=2, model=4),
                                   lj.LParameters(**INFEAS_KW)))
    mesh42 = jmesh.make_mesh(data=4, model=2)
    cold = jsolve(*rnd, mesh42, par)
    ref["warm_x"] = rec(jsolve(*rnd, mesh42, par, warm_x=cold.x))
    ref["warm_xy"] = rec(jsolve(*rnd, mesh42, par, warm_x=cold.x, warm_y=cold.y))
    kkt = lj.LParameters(**KKT_KW)
    ref["kkt"] = rec(jsolve(*rnd, mesh42, kkt))
    ref["kkt.unsharded"] = rec(jadmm.admm_solve(*rnd, kkt))

    c = make_quadrotor_controller()
    dims, prob = c.dims, c._prob
    P, A, lineq, uineq = jqp.build_time_invariant(dims, prob)
    q, l, u = jqp.build_time_varying(dims, prob, lineq, uineq, jnp.zeros((QUAD_B, 12)),
                                     jnp.zeros((QUAD_B, 4)), c._y_ref, c._u_ref,
                                     c._du_ref, c._u_meas)
    ref["quadrotor"] = rec(jsolve(P, A, q, l, u, jmesh.make_mesh(data=2, model=4), par,
                                  eq_mask=jnp.arange(dims.m) < dims.n_eq))
    return ref


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Every rank's record of every scenario (rank -> npz) and the JAX
    references, computed while the ranks run."""
    d = tmp_path_factory.mktemp("qp_sharded_ranks")
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")]))
    for var in ("XLA_FLAGS", "WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(var, None)
    procs, logs = [], []
    try:
        for r in range(WORLD):
            log = open(d / f"rank{r}.log", "w")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, __file__, "--rank", str(r), "--world", str(WORLD),
                 "--init", f"file://{d / 'store'}", "--out", str(d)],
                cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT))
        ref = jax_references()
        end = time.monotonic() + SPAWN_TIMEOUT_S
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
    ranks = {r: dict(np.load(d / f"rank{r}.npz")) for r in range(WORLD)}
    return ranks, ref


def solution(rank, key):
    return {f: rank[f"{key}.{f}"] for f in SOLUTION_FIELDS}


def assert_matches_jax(got, want, y_tol=PARITY_TOL):
    """float64 parity with the JAX package's solve_sharded."""
    assert np.array_equal(got["status"], want["status"])
    assert np.array_equal(got["iters"], want["iters"]), (got["iters"], want["iters"])
    assert np.abs(got["x"] - want["x"]).max() <= PARITY_TOL
    assert np.abs(got["y"] - want["y"]).max() <= y_tol


def assert_kkt(case, got, bound=1e-5):
    P, A, q, l, u = case
    for i in range(q.shape[0]):
        err = kkt_error(P, A, q[i], l[i], u[i], got["x"][i], got["y"][i])
        assert err < bound, f"instance {i}: {err}"


# -- the mesh -------------------------------------------------------------------
@pytest.mark.parametrize("data,model", MESHES)
def test_mesh_layout_and_groups(run, data, model):
    """Rank r sits at data index r // model and model index r % model (JAX's
    grid.reshape(data, model)); each axis's collectives run over the ranks
    that share the other index, in the order of their index."""
    ranks, _ = run
    key = f"mesh{data}x{model}"
    for r in range(WORLD):
        di, mi = r // model, r % model
        assert list(ranks[r][f"{key}.place"]) == [r, di, mi, di * (8 // data), data, model]
        batch_group = [d * model + mi for d in range(data)]
        row_group = [di * model + j for j in range(model)]
        assert list(ranks[r][f"{key}.data"]) == batch_group
        assert list(ranks[r][f"{key}.model"]) == row_group
        assert ranks[r][f"{key}.data_sum"][0, 0] == sum(batch_group)
        assert ranks[r][f"{key}.model_sum"][0, 0] == sum(row_group)
        assert ranks[r][f"{key}.all_max"][0, 0] == WORLD - 1


def test_mesh_refuses_a_shape_that_is_not_the_world(run):
    ranks, _ = run
    for r in range(WORLD):
        for key in ("refuse_3x2", "refuse_model3", "refuse_2x2", "refuse_model0"):
            assert ranks[r][key], key


def test_rank_processes_import_neither_jax_nor_the_jax_package(run):
    ranks, _ = run
    for r in range(WORLD):
        assert ranks[r]["foreign_modules"].size == 0, ranks[r]["foreign_modules"]


def test_random_qp_is_test_admms():
    from test_admm import random_qp as jax_suite_random_qp

    for args in ((0, 10, 17, 8), (1, 6, 9, 3)):
        a = random_qp(np.random.default_rng(args[0]), *args[1:])
        b = jax_suite_random_qp(np.random.default_rng(args[0]), *args[1:])
        assert all(np.array_equal(x, y) for x, y in zip(a, b))


# -- the cases of tests/test_qp_sharded.py ---------------------------------------
@pytest.mark.parametrize("data,model", MESHES)
def test_matches_unsharded(run, data, model):
    ranks, ref = run
    got = solution(ranks[0], f"random{data}x{model}")
    assert np.all(got["status"] == 1)
    assert np.allclose(got["x"], ref["random.unsharded"]["x"], atol=1e-6)
    assert_kkt(random_case(), got)
    assert_matches_jax(got, ref[f"random{data}x{model}"])


def test_quadrotor_qp_sharded(run):
    ranks, ref = run
    got = solution(ranks[0], "quadrotor")
    assert np.all(got["status"] == 1)
    assert np.abs(ranks[0]["quadrotor.cmd"] - GOLDEN_CMD).max() <= 1e-4
    assert_matches_jax(got, ref["quadrotor"])


def test_badly_scaled_full_feature_parity(run):
    ranks, ref = run
    got = solution(ranks[0], "badly_scaled")
    assert np.array_equal(got["status"], ref["badly_scaled.unsharded"]["status"])
    assert np.all(got["status"] == 1)
    assert np.allclose(got["x"], ref["badly_scaled.unsharded"]["x"], atol=1e-6)
    assert_kkt(badly_scaled_case(), got)
    assert_matches_jax(got, ref["badly_scaled"])


def test_infeasibility_certificate_sharded(run):
    ranks, ref = run
    got = solution(ranks[0], "infeasible")
    assert np.all(got["status"] == -3)  # OSQP_PRIMAL_INFEASIBLE
    # y is the certificate's dual iterate, 1.6e3 here and growing with every
    # iteration: held within 1e-8 of its size.  The JAX package's own
    # unsharded, (1, 1) and (2, 4) solves of this case give duals 1.6e-7 to
    # 3.0e-7 apart (ROADMAP.md, known reference behaviours)
    want = ref["infeasible"]
    assert_matches_jax(got, want, y_tol=PARITY_TOL * np.abs(want["y"]).max())


def test_uneven_batch_raises_on_every_rank(run):
    ranks, _ = run
    for r in range(WORLD):
        assert ranks[r]["uneven_raised"]


def test_primal_only_warm_start(run):
    ranks, ref = run
    cold, warm, warm2 = (solution(ranks[0], k) for k in ("random4x2", "warm_x", "warm_xy"))
    assert np.all(cold["status"] == 1) and np.all(warm["status"] == 1)
    assert np.allclose(warm["x"], cold["x"], atol=1e-6)
    assert np.all(warm2["status"] == 1)
    assert np.all(warm2["iters"] <= cold["iters"])
    for key in ("warm_x", "warm_xy"):
        assert_matches_jax(solution(ranks[0], key), ref[key])


# -- beyond tests/test_qp_sharded.py ------------------------------------------------
def test_every_rank_returns_the_same_global_solution(run):
    ranks, _ = run
    keys = [k for k in ranks[0] if k.split(".")[-1] in SOLUTION_FIELDS or k.endswith(".cmd")]
    assert len(keys) > 50
    for r in range(1, WORLD):
        for k in keys:
            assert np.array_equal(ranks[r][k], ranks[0][k], equal_nan=True), (r, k)


def test_kkt_seed_is_reduced_over_the_row_shards(run):
    """cold_start="kkt" on (4, 2): the port sums the seed's row product over
    the shards like every cross-space product, so its sharded solve is the
    unsharded one; the JAX package's seed is a shard's partial sum, so its
    sharded solve departs from its own unsharded one (ROADMAP.md, known
    reference behaviours)."""
    ranks, ref = run
    got, unsharded = solution(ranks[0], "kkt"), ref["kkt.unsharded"]
    assert np.all(got["status"] == 1)
    assert np.abs(got["x"] - unsharded["x"]).max() <= 1e-11
    assert np.abs(ref["kkt"]["x"] - unsharded["x"]).max() > 1e-11


def test_lmpc_fleet_on_a_data_model_mesh(run):
    """Model-axis replicas solve the same rows and are counted once: the
    fleet on (4, 2) returns each data index's plain solve, and the stats of
    the eight instances."""
    ranks, _ = run
    for r in range(WORLD):
        got = ranks[r]
        assert np.array_equal(got["fleet.cmd"], got["fleet.plain_cmd"])
        assert np.array_equal(got["fleet.status"], got["fleet.plain_status"])
        status, iters = got["fleet.plain_status"], got["fleet.plain_iters"]
        want = [8] + [int((status == s).sum()) for s in range(5)] + [iters.sum() / 8,
                                                                     iters.max()]
        assert np.allclose(got["fleet.stats"], want, rtol=0, atol=1e-12), got["fleet.stats"]


if __name__ == "__main__":
    sys.exit(rank_main())
