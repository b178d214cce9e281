"""The arithmetic of the end-to-end metrics and of their spread."""

from __future__ import annotations

import statistics


def percentile(values, pct: float) -> float:
    """The ``pct`` percentile of ``values`` by linear interpolation between
    order statistics (``statistics.quantiles(..., method="inclusive")``)."""
    values = list(values)
    if len(values) == 1:
        return float(values[0])
    cuts = statistics.quantiles(values, n=100, method="inclusive")
    if pct == int(pct) and 1 <= pct <= 99:
        return float(cuts[int(pct) - 1])
    raise ValueError("pct must be a whole number from 1 to 99")


def rate(work: float, seconds: float) -> float:
    """Work completed a second over the whole window."""
    if seconds <= 0:
        raise ValueError("a window has a positive length")
    return work / seconds


def spread(values) -> float:
    """Distance between the first and third quartiles as a share of the
    median (``statistics.quantiles(values, n=4)``)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med
