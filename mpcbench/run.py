"""The benchmark of ``libmpc_tpu_torch``: one run of one cell.

    python3 -m mpcbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  ``BENCHMARK.json`` names the cell's
configuration and traffic; everything else is found by name under
``mpcbench/``: the configuration's sizes (``configs/<config>.json``) and its
builder (``configs/<builder>.py``), the traffic (``traffic/<traffic>.json``)
and one reader per metric (``metrics/<metric>.py``).

A run sets up (imports, the card, the kernel library, the controller, the
warm-up), measures a window of whole closed-loop steps for ``--seconds``,
and with ``--trace 1`` collects the program's counters over that window and
then profiles a sub-window.  Once the window has closed and the program's
state is freed, the plain reference judges the kept lane-steps.  The last
line of standard output is one JSON object; the numbers compared, each
beside its limit, are the last lines of standard error and the last key of
that object.

A cell runs in this one process on one card (:func:`measure`), unless its
configuration's builder supplies ``run(cell, seed, seconds, trace, parts)``
of its own, which takes the run over (ranks, a launcher, several cards)
and returns what :func:`measure` returns, ``device.count`` the cards it
used.

Exit codes: 0 with a result; 2 for bad arguments or a missing card; 3 when
JAX or the JAX package was loaded; anything else is an error of the run.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()  # before the heavy imports: set-up starts here

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

from mpcbench import stats  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "libmpc_tpu")  # whole top-level names


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A workload of ``BENCHMARK.json`` and everything it names."""

    def __init__(self, name: str, bench_file: Path = ROOT / "BENCHMARK.json"):
        bench = json.loads(bench_file.read_text())
        work = {w["name"]: w for w in bench["workloads"]}
        if name not in work:
            raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                             f"{sorted(work)}")
        self.workload = work[name]
        conf = {c["name"]: c for c in bench["configs"]}[self.workload["config"]]
        self.cfg = json.loads((ROOT / conf["file"]).read_text())
        self.traffic = json.loads(
            (HERE / "traffic" / f"{self.workload['traffic']}.json").read_text())
        self.builder = load_module(HERE / "configs" / self.cfg["builder"],
                                   f"mpcbench_config_{self.cfg['name']}")
        applies = lambda m: name in m.get("workloads", [name])
        self.end_to_end = [m for m in bench["end_to_end"] if applies(m)]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if applies(m) and m["moves"] in reported]
        self.chips = int(self.workload["chips"])

    def reader(self, metric: dict):
        """``metrics/<name>.py``, or for a metric split by the end-to-end
        metric it moves (``<quantity>.<suffix>``) the quantity's reader."""
        name = metric["name"]
        path = HERE / "metrics" / f"{name}.py"
        if not path.is_file():
            path = HERE / "metrics" / f"{name.split('.')[0]}.py"
        return load_module(path, f"mpcbench_metric_{name}")


def forbidden_modules():
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def power_limit() -> str:
    """The card's name and power limit from ``nvidia-smi``, or why not."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as err:
        return f"not read ({type(err).__name__})"


def measure(cell: Cell, seed: int, seconds: float, trace: bool, device="cuda",
            t_start: float = T_PROCESS, hook=None, parts=None):
    """One run of ``cell``; returns (result dict, checks).  ``hook``, where
    given, receives the built System before the warm-up (tests break the
    timed path there); ``parts`` holds set-up seconds already spent."""
    import torch

    from mpcbench import check, generator, loop

    parts = dict(parts or {})
    t = time.perf_counter()
    import libmpc_tpu_torch  # noqa: F401

    parts["import_s"] = time.perf_counter() - t
    # the configuration's precision, for the harness's products (the plant)
    torch.backends.cuda.matmul.allow_tf32 = bool(cell.cfg["tf32"])
    torch.backends.cudnn.allow_tf32 = bool(cell.cfg["tf32"])
    if torch.device(device).type == "cuda":
        from libmpc_tpu_torch.ops import _build

        t = time.perf_counter()
        _build.library()
        parts["library_s"] = time.perf_counter() - t
        parts["nvcc_build_s"] = _build.build_info.get("seconds", 0.0)
    t = time.perf_counter()
    system = cell.builder.build(cell.cfg, cell.traffic, device)
    if hook is not None:
        hook(system)
    parts["controller_s"] = time.perf_counter() - t
    t = time.perf_counter()
    loop.warm_up(system, cell.traffic, seed)
    parts["warmup_s"] = time.perf_counter() - t
    graphs_before = _graph_count()

    run = types.SimpleNamespace(cfg=cell.cfg, traffic=cell.traffic, shared={}, notes={},
                                profile=None, profile_iters=[], power_limit="not read")
    readers = [(m, cell.reader(m)) for m in (cell.per_layer if trace else cell.end_to_end)]
    states = {}
    if trace:
        for m, r in readers:
            states[m["name"]] = r.open(run) if hasattr(r, "open") else None
    episodes = generator.Episodes(cell.traffic, system.nx, system.nu, seed, 0,
                                  system.dtype, system.device)
    lanes = generator.sample_lanes(cell.traffic, seed, 4096, system.device)
    lp = loop.Loop(system, episodes)
    run.setup_s = time.perf_counter() - t_start
    run.window = loop.run_window(system, lp, lanes, seconds, keep_iters=trace)
    captures = _graph_count() - graphs_before
    if trace:
        for m, r in readers:
            if hasattr(r, "close"):
                states[m["name"]] = r.close(run, states[m["name"]])
    cuda = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if trace:
        t = time.perf_counter()
        run.profile, run.profile_iters = loop.profile_window(system, lp, cell.traffic)
        parts["profile_s"] = time.perf_counter() - t
    run.power_limit = power_limit() if cuda else "no card"
    metrics = {}
    for m, r in readers:
        v = r.read(run, states.get(m["name"]))
        if v is not None and _finite(v) is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    # the program's state goes before the reference runs
    samples = {k: torch.cat([s[k] for s in run.window.samples])
               for k in run.window.samples[0]}
    success = system.success
    lp_length = lp.episodes.length
    del system, lp, episodes
    run.window.samples = run.window.iters = run.profile_iters = None
    run.shared.clear()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    checks = check.judge(cell.builder, cell.cfg, samples, device, success)
    parts["check_s"] = time.perf_counter() - t
    if captures:
        checks["graph_captures_in_window"] = (captures, None)

    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": 1,  # this process drives one card
           "memory_peak_bytes": int(peak)}
    result = {"correct": check.verdict(checks), "attempted": run.window.attempted,
              "failed": run.window.failed, "metrics": metrics, "device": dev}
    if trace and run.profile is not None:
        from mpcbench.trace import family, top

        dev["busy_s"] = run.profile.busy_s()
        dev["window_s"] = run.profile.window_s
        result["breakdown"] = {"device_ops": top(run.profile.seconds_by(family)),
                               "idle_gaps": top(run.profile.idle_gaps())}
    result["run"] = {"steps": run.window.steps, "cold_steps": run.window.cold_steps,
                     "step_ms": _step_summary(run.window.step_s, lp_length),
                     "wall_s": run.window.wall_s, "setup_parts": parts,
                     "power": run.power_limit, "notes": run.notes}
    result["checks"] = {k: {"value": _finite(v), "limit": lim} for k, (v, lim) in checks.items()}
    return result, checks


def _step_summary(step_s, length):
    """Median step milliseconds by the step's place in its episode (the
    first five places, then the rest), and the window's 95th and 99th
    percentiles."""
    ms = [1e3 * t for t in step_s]
    by = [[v for i, v in enumerate(ms) if i % length == k] for k in range(min(5, length))]
    rest = [v for i, v in enumerate(ms) if i % length >= 5]
    med = lambda v: round(statistics.median(v), 2) if v else None
    return {"by_place": [med(v) for v in by], "rest": med(rest),
            "p95": round(stats.percentile(ms, 95), 2) if len(ms) > 1 else None,
            "p99": round(stats.percentile(ms, 99), 2) if len(ms) > 1 else None}


def _finite(v):
    """A number JSON can carry: a reading that is not finite becomes null."""
    return v if v == v and abs(v) != float("inf") else None


def _graph_count() -> int:
    """CUDA graphs the per-instance ADMM has captured so far (its cache)."""
    admm = sys.modules.get("libmpc_tpu_torch.ops.admm")
    cache = getattr(getattr(admm, "_BlockGraph", None), "_cache", None)
    return len(cache) if cache is not None else 0


def runner(cell: Cell):
    """The function that makes a run of ``cell``: its builder's own ``run``,
    or :func:`measure`."""
    return getattr(cell.builder, "run", measure)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    parts = {"python_s": time.perf_counter() - T_PROCESS}
    t = time.perf_counter()
    import torch

    parts["torch_import_s"] = time.perf_counter() - t
    cell = Cell(args.workload)
    t = time.perf_counter()
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"needs {cell.chips} CUDA device(s), found {have}: no result",
              file=sys.stderr)
        return 2
    torch.zeros(1, device="cuda")  # the context, counted apart from the library
    parts["cuda_init_s"] = time.perf_counter() - t
    result, checks = runner(cell)(cell, args.seed, args.seconds, bool(args.trace),
                                  parts=parts)
    bad = forbidden_modules()
    if bad:
        print(f"JAX or the JAX package was loaded: {bad}: no result", file=sys.stderr)
        return 3
    for name, (v, lim) in checks.items():
        verdict = "" if lim is None else (" ok" if v <= lim else " OVER")
        print(f"check {name}: {v!r} limit {lim!r}{verdict}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
