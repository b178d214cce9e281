"""Reduction of a ``torch.profiler`` run over the profiled sub-window.

The raw events are read from the profiler's Kineto results, which holds one
record per host operator, span and device activity, without building the
profiler's event tree (a UGV step runs about a million kernels).  What comes
out is plain data that the per-layer metric readers and the result's
``breakdown`` use: the device activities inside the sub-window, the union of
their intervals, kernel families, and the idle gaps named by what the host
was doing.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

WINDOW_SPAN = "mpcbench.window"
STEP_SPANS = ("optimize", "plant")

# (substring of a kernel's name, family), the first match wins; the port's
# hand-written kernels by their entry names in libmpc_tpu_torch/csrc/*.cu
FAMILIES = (
    ("admm_staged_kernel", "K1 admm_fused"), ("admm_stream_kernel", "K1 admm_fused"),
    ("chol_inverse", "K2 chol_inverse"), ("qp_inner", "K3 qp_inner"),
    ("traj_factor", "K4 traj_factor"), ("traj_sweep", "K5 traj_sweep"),
    ("gemm", "cuBLAS"), ("gemv", "cuBLAS"), ("cutlass", "cuBLAS"), ("bmm", "cuBLAS"),
    ("cublas", "cuBLAS"), ("memcpy", "memcpy and memset"), ("memset", "memcpy and memset"),
    ("reduce", "reductions"),
)


def family(name: str) -> str:
    key = name.lower()
    for word, fam in FAMILIES:
        if word in key:
            return fam
    return "elementwise and other"


def is_kernel(name: str) -> bool:
    """A device activity that is a kernel (not a copy or a fill)."""
    key = name.lower()
    return not (key.startswith("memcpy") or key.startswith("memset"))


@dataclasses.dataclass
class Profile:
    """The sub-window's device activities and host events, times in ns."""

    window: Tuple[int, int]
    device: List[Tuple[str, int, int]]  # (name, start, end)
    host: List[Tuple[str, int, int]]  # operators and spans
    steps: int

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def union(self) -> np.ndarray:
        """Merged device intervals (k, 2) clipped to the window."""
        if not self.device:
            return np.zeros((0, 2), dtype=np.int64)
        iv = np.array([(s, e) for _, s, e in self.device], dtype=np.int64)
        iv = np.clip(iv, self.window[0], self.window[1])
        iv = iv[np.argsort(iv[:, 0], kind="stable")]
        ends = np.maximum.accumulate(iv[:, 1])
        new = np.ones(len(iv), dtype=bool)
        new[1:] = iv[1:, 0] > ends[:-1]
        starts = iv[new, 0]
        group = np.cumsum(new) - 1
        merged_end = np.zeros(len(starts), dtype=np.int64)
        np.maximum.at(merged_end, group, ends)
        return np.stack([starts, merged_end], axis=1)

    def busy_s(self) -> float:
        u = self.union()
        return float((u[:, 1] - u[:, 0]).sum()) / 1e9

    def kernels(self) -> int:
        return sum(1 for name, _, _ in self.device if is_kernel(name))

    def seconds_by(self, pick) -> dict:
        """Device seconds summed by ``pick(name)`` (None: left out)."""
        out: dict = {}
        for name, s, e in self.device:
            key = pick(name)
            if key is not None:
                out[key] = out.get(key, 0.0) + (e - s) / 1e9
        return out

    def idle_gaps(self) -> dict:
        """Idle seconds of the device inside the window, summed by what the
        host was doing at each gap's midpoint: the benchmark's span
        (``optimize``, ``plant`` or neither) and the innermost host operator
        then running."""
        u = self.union()
        bounds = np.concatenate([[self.window[0]], u.ravel(), [self.window[1]]])
        gaps = bounds.reshape(-1, 2)
        gaps = gaps[gaps[:, 1] > gaps[:, 0]]
        if len(gaps) == 0:
            return {}
        mids = (gaps[:, 0] + gaps[:, 1]) // 2
        spans = [(s, e, n) for n, s, e in self.host if n in STEP_SPANS]
        ops = [(s, e, n) for n, s, e in self.host
               if n not in STEP_SPANS and n != WINDOW_SPAN]
        span_at = _innermost(spans, mids)
        op_at = _innermost(ops, mids)
        out: dict = {}
        for (g0, g1), sp, op in zip(gaps, span_at, op_at):
            key = f"{sp or 'between steps'}: {op or 'python'}"
            out[key] = out.get(key, 0.0) + (g1 - g0) / 1e9
        return out


def _innermost(events, points):
    """For each point, the name of the latest-starting event that contains
    it (nested host events: the innermost), or None."""
    out = [None] * len(points)
    if not events:
        return out
    events = sorted(events)
    order = np.argsort(points, kind="stable")
    stack: list = []
    i = 0
    for j in order:
        p = points[j]
        while i < len(events) and events[i][0] <= p:
            stack.append(events[i])
            i += 1
        while stack and stack[-1][1] < p:
            stack.pop()
        # an event lower in the stack may have ended while a later one runs
        for s, e, n in reversed(stack):
            if e >= p:
                out[j] = n
                break
    return out


def top(d: dict, n: int = 10):
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def read_profile(prof, steps: int) -> Profile:
    """The sub-window of a finished ``torch.profiler.profile`` whose steps
    ran inside a ``record_function(WINDOW_SPAN)``."""
    window = None
    device, host = [], []
    for name, kind, on_device, s, e in _raw_events(prof):
        if on_device:
            # kernels, copies and fills; the spans' mirrors on the device's
            # timeline (user annotations) are no device work
            if any(k in kind for k in ("kernel", "memcpy", "memset")) or (
                    not kind and name not in STEP_SPANS + (WINDOW_SPAN,)):
                device.append((name, s, e))
        elif name == WINDOW_SPAN:
            window = (s, e)
        else:
            host.append((name, s, e))
    if window is None:
        raise RuntimeError("the profile holds no window span")
    device = [(n, s, e) for n, s, e in device if e > window[0] and s < window[1]]
    host = [(n, s, e) for n, s, e in host if e > window[0] and s < window[1]]
    return Profile(window=window, device=device, host=host, steps=steps)


def _kind(ev) -> str:
    """The event's activity type where this torch reports one ("" where it
    does not; "user_annotation" for a span)."""
    if hasattr(ev, "activity_type"):
        return str(ev.activity_type()).lower()
    if hasattr(ev, "is_user_annotation") and ev.is_user_annotation():
        return "user_annotation"
    return ""


def _raw_events(prof):
    """(name, activity type, on the device?, start ns, end ns) of every
    recorded event."""
    out = []
    for ev in prof.profiler.kineto_results.events():
        s = ev.start_ns()
        out.append((ev.name(), _kind(ev), str(ev.device_type()).endswith("CUDA"), s,
                    s + ev.duration_ns()))
    return out
