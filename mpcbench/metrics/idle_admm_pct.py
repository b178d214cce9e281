"""Share of the profiled sub-window in which the card was idle while the
host was inside the ADMM solve: the span ``libmpc.admm.solve`` of
``libmpc_tpu_torch/ops/admm.py::admm_solve``, in %.

The card's idle intervals are the sub-window less the union of its
activities (what ``device_idle_pct`` counts).  They are intersected exactly
with the union of the span's intervals on the host timeline, which the
profiler keeps on the clock of the card's activities, so the share is a part
of ``device_idle_pct`` of the same run.  A profile that holds no such span (a
program without spans) reports nothing.

:func:`percent` is shared with ``idle_sqp_pct`` and ``idle_inner_pct``.
"""

import dataclasses

import numpy as np

SPANS = ("libmpc.admm.solve",)


def intersect(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The intersection of two sorted lists of disjoint intervals."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((0, 2), dtype=np.int64)
    k = len(a) + len(b)
    t = np.concatenate([a[:, 0], b[:, 0], a[:, 1], b[:, 1]])
    d = np.concatenate([np.ones(k, dtype=np.int64), -np.ones(k, dtype=np.int64)])
    order = np.lexsort((d, t))  # at one time the ends first
    t, inside = t[order], np.cumsum(d[order])
    both = np.nonzero(inside[:-1] == 2)[0]
    out = np.stack([t[both], t[both + 1]], axis=1)
    return out[out[:, 1] > out[:, 0]]


def length(iv: np.ndarray) -> int:
    return int((iv[:, 1] - iv[:, 0]).sum())


def idle(profile) -> np.ndarray:
    """The card's idle intervals inside the sub-window."""
    bounds = np.concatenate([[profile.window[0]], profile.union().ravel(),
                             [profile.window[1]]]).reshape(-1, 2)
    return bounds[bounds[:, 1] > bounds[:, 0]]


def spans(profile, names):
    """The union of the host intervals of the spans named in ``names``,
    clipped to the sub-window (the merge ``Profile.union`` makes of the
    card's activities), or None if the profile holds none."""
    iv = [ev for ev in profile.host if ev[0] in names]
    return dataclasses.replace(profile, device=iv).union() if iv else None


def idle_under(profile, inside, outside=()):
    """Idle seconds of the card while the host was inside a span named in
    ``inside`` and not inside one named in ``outside``; None if the profile
    holds no span of ``inside``."""
    within = spans(profile, inside)
    if within is None:
        return None
    part = intersect(idle(profile), within)
    ns = length(part)
    out = spans(profile, outside) if outside else None
    if out is not None:
        ns -= length(intersect(part, out))
    return ns / 1e9


def percent(run, inside, outside=()):
    p = run.profile
    if p is None or p.window_s <= 0:
        return None
    s = idle_under(p, inside, outside)
    return None if s is None else 100.0 * s / p.window_s


def read(run, state=None):
    return percent(run, SPANS)
