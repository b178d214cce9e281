"""The comparison that decides ``correct``: served commands against the
plain reference's, on the lane-steps the window kept.

A configuration's builder supplies ``answers(cfg, samples, device, dtype,
tf32)``, the reference's commands at the kept states.  The numbers compared
are statistics of the per-lane gap (the largest absolute difference over a
command's entries) over the kept lane-steps that the program solved
(status SUCCESS) and the float64 reference solved too; the configuration's
``check`` names which are compared and gives each its limit.
"""

from __future__ import annotations

import torch

# statistics of a per-lane gap, by the suffix a configuration's limits use
STATS = {
    "max": lambda g: g.max(),
    "median": lambda g: torch.quantile(g, 0.5),
    "p75": lambda g: torch.quantile(g, 0.75),
}


def gaps(samples, ref, device, success=0):
    """Per-lane command gaps (float64) on the lane-steps both sides solved,
    and how many kept lane-steps the reference left unsolved."""
    ok = (samples["status"].to(device) == success) & ref["converged"]
    g = (samples["cmd"].to(device=device, dtype=torch.float64) - ref["cmd"]).abs()
    g = torch.nan_to_num(g, nan=float("inf")).amax(dim=1)
    return g[ok], int((~ref["converged"]).sum())


def readings(g, name: str = "cmd_gap") -> dict:
    """Every statistic of :data:`STATS` of the gaps ``g``, as
    ``<name>_<statistic>`` (infinite when nothing was compared)."""
    g = torch.nan_to_num(g, nan=float("inf"))
    return {f"{name}_{k}": float(f(g)) if g.numel() else float("inf")
            for k, f in STATS.items()}


def residual_readings(builder, cfg, samples, device, success=0) -> dict:
    """The statistics of each per-lane residual that the builder's
    ``residuals`` works out on the solved lane-steps (none where it has no
    such function)."""
    if not hasattr(builder, "residuals"):
        return {}
    ok = samples["status"].to(device) == success
    out = {}
    for name, r in builder.residuals(cfg, samples, device).items():
        out.update(readings(r[ok], name))
    return out


def judge(builder, cfg, samples, device, success=0) -> dict:
    """The numbers of the check, each (value, limit), limit None where the
    number is reported and not compared."""
    ref = builder.answers(cfg, samples, device)
    g, unsolved = gaps(samples, ref, device, success)
    limits = cfg["check"]["limits"]
    found = dict(readings(g), **residual_readings(builder, cfg, samples, device, success))
    out = {k: (v, limits.get(k)) for k, v in found.items()}
    out["compared"] = (int(g.numel()), None)
    out["reference_unsolved"] = (unsolved, None)
    return out


def verdict(checks: dict) -> bool:
    """Correct: something was compared and every compared number is within
    its limit."""
    if checks["compared"][0] == 0:
        return False
    return all(lim is None or v <= lim for v, lim in checks.values())
