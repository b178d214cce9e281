"""Readings that set the limits of ``correct``: the program's, its
control's and a planted fault's, seed by seed, at a cell's own size.

    python3 -m mpcbench.control --workload <name> --seeds 11,12,13 --seconds 51
    python3 -m mpcbench.control --workload <name> --seeds 11,12,13 --seconds 15 --fault half

For each seed, one window of the cell as a run measures it (the same
traffic, the same kept lane-steps), then:

* ``program``: the statistics of the gaps of the program's answers against
  the float64 reference (the lower readings of the limits);
* ``control_tf32``: the reference itself put in the program's place and
  computed in the precision below the configuration's (float32 with TF32
  products, the configurations stating float32 with TF32 off), at the same
  kept states, judged by the same rule (the upper readings).  A lane whose
  solve does not converge to the tolerance TF32 can reach
  (``reference.qp_ipm.floor``) counts as failed and is not compared;
* with ``--fault <name>``, ``fault_<name>`` in place of both: the program
  with that fault of :mod:`mpcbench.faults` planted in its timed path.

One JSON line a seed and reading.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from mpcbench import check, faults, generator, loop, run


def control_samples(builder, cfg, samples, device, success=0):
    """The control's answers at the kept states, shaped as the program's
    samples; a lane the control did not solve has a status other than
    ``success``."""
    ans = builder.answers(cfg, samples, device, dtype=torch.float32, tf32=True)
    out = dict(samples)
    out.update({k: v for k, v in ans.items() if k != "converged"})
    out["status"] = torch.where(ans["converged"], success, success + 1)
    return out


def readings(builder, cfg, samples, device, success=0):
    g, unsolved = check.gaps(samples, builder.answers(cfg, samples, device), device, success)
    failed = int((samples["status"].to(device) != success).sum())
    return dict(check.readings(g), compared=int(g.numel()), failed=failed,
                reference_unsolved=unsolved,
                **check.residual_readings(builder, cfg, samples, device, success))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--fault", choices=sorted(faults.FAULTS))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = run.Cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    system = cell.builder.build(cell.cfg, cell.traffic, args.device)
    if args.fault:
        faults.FAULTS[args.fault](system)
    loop.warm_up(system, cell.traffic, seeds[0])
    for seed in seeds:
        eps = generator.Episodes(cell.traffic, system.nx, system.nu, seed, 0, system.dtype,
                                 system.device)
        lanes = generator.sample_lanes(cell.traffic, seed, 4096, system.device)
        w = loop.run_window(system, loop.Loop(system, eps), lanes, args.seconds, False)
        samples = {k: torch.cat([s[k] for s in w.samples]) for k in w.samples[0]}
        ok = system.success
        if args.fault:
            rows = {f"fault_{args.fault}": readings(cell.builder, cell.cfg, samples,
                                                    args.device, ok)}
        else:
            rows = {"program": readings(cell.builder, cell.cfg, samples, args.device, ok),
                    "control_tf32": readings(cell.builder, cell.cfg, control_samples(
                        cell.builder, cell.cfg, samples, args.device, ok), args.device, ok)}
        for name, r in rows.items():
            r["correct"] = check.verdict(
                dict({k: (r[k], lim) for k, lim in cell.cfg["check"]["limits"].items()},
                     compared=(r["compared"], None)))
            print(json.dumps({"workload": args.workload, "seed": seed, "reading": name,
                              "steps": w.steps, **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
