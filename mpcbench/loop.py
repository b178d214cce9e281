"""The closed loop every cell drives: warm-up, the measured window, the
traced counters and the profiled sub-window.

A configuration's builder (``mpcbench/configs/<config>.py``) hands over a
:class:`System`: the controller under test, the plant, the cold start, and
what the check keeps of a step.  The loop is the same for every cell:

* an episode starts cold (``System.reset``) from states the traffic draws;
* a step calls the controller's own ``optimize`` on the whole batch, waits
  for the device, then advances the plant (the benchmark's code) and waits
  again, so every step ends in ``torch.cuda.synchronize()``;
* the window runs whole steps until its seconds have passed.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import torch
from torch.profiler import record_function

from . import generator, trace


@dataclasses.dataclass
class System:
    """What a configuration's builder returns."""

    controller: Any
    nx: int
    nu: int
    dtype: Any
    device: Any
    reset: Callable[[], None]  # make the controller's next optimize cold
    plant: Callable[[Any, Any, Optional[Any]], Any]  # (x, u, noise) -> next x
    keep: Callable[[Any, Any, Any, Any], dict]  # (lanes, x, u_prev, result) -> tensors
    before: Callable[[Any], None] = lambda x: None  # per-step set-up at state x
    success: int = 0  # the ResultStatus value of a solved lane


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Loop:
    """Episodes of one stream driven step by step."""

    def __init__(self, system: System, episodes: generator.Episodes):
        self.system, self.episodes = system, episodes
        self.k = 0  # steps taken in the current episode
        self.x = self.u = None

    @property
    def next_is_cold(self) -> bool:
        return self.k % self.episodes.length == 0

    def step(self):
        """One control step; returns (result, optimize seconds, state, last
        command) with the state and command the step started from."""
        sysm = self.system
        if self.next_is_cold:
            sysm.reset()
            self.x, self.u = self.episodes.start()
            self.k = 0
        x, u = self.x, self.u
        sysm.before(x)
        sync(sysm.device)
        t0 = time.perf_counter()
        with record_function("optimize"):
            r = sysm.controller.optimize(x, u)
            sync(sysm.device)
        dt = time.perf_counter() - t0
        with record_function("plant"):
            self.x = sysm.plant(x, r.cmd, self.episodes.noise())
            self.u = r.cmd
            sync(sysm.device)
        self.k += 1
        return r, dt, x, u


@dataclasses.dataclass
class Window:
    steps: int = 0
    cold_steps: int = 0
    wall_s: float = 0.0
    step_s: list = dataclasses.field(default_factory=list)
    attempted: int = 0
    failed: int = 0
    samples: list = dataclasses.field(default_factory=list)
    iters: list = dataclasses.field(default_factory=list)  # per step, traced runs


def warm_up(system: System, traffic: dict, seed: int) -> int:
    """The warm-up steps, from a stream of their own: a cold step and warm
    ones, every shape the window meets."""
    eps = generator.Episodes(traffic, system.nx, system.nu, seed, 1, system.dtype,
                             system.device)
    loop = Loop(system, eps)
    n = int(traffic["warmup_steps"])
    for _ in range(n):
        loop.step()
    return n


def run_window(system: System, loop: Loop, lanes: torch.Tensor, seconds: float,
               keep_iters: bool) -> Window:
    """Whole steps until ``seconds`` have passed; every step's time, its
    failures, the check's lanes and (``keep_iters``) the controller's
    per-lane iteration counts."""
    w = Window()
    failed = torch.zeros((), dtype=torch.int64, device=system.device)
    t_start = time.perf_counter()
    while True:
        cold = loop.next_is_cold
        r, dt, x, u = loop.step()
        w.step_s.append(dt)
        w.cold_steps += cold
        failed += (r.status != system.success).sum()
        w.attempted += int(r.status.numel())
        idx = lanes[w.steps % lanes.shape[0]]
        kept = system.keep(idx, x, u, r)
        kept["cold"] = torch.full((idx.numel(),), bool(cold), device=idx.device)
        w.samples.append(kept)
        if keep_iters:
            w.iters.append(system.controller._last_iters)
        w.steps += 1
        if time.perf_counter() - t_start >= seconds:
            break
    w.wall_s = time.perf_counter() - t_start
    w.failed = int(failed)
    return w


def profile_window(system: System, loop: Loop, traffic: dict):
    """The profiled sub-window of a traced run: ``profile_steps`` steps, from
    the start of an episode or warm ones, under ``torch.profiler``.
    Returns (:class:`trace.Profile`, per-step iteration counts)."""
    from torch.profiler import ProfilerActivity, profile

    n = int(traffic["profile_steps"])
    if traffic.get("profile_from_episode_start", False):
        while not loop.next_is_cold:
            loop.step()
    else:
        # warm steps: none of them may start an episode
        left = loop.episodes.length - loop.k % loop.episodes.length
        if loop.next_is_cold or left < n:
            while not loop.next_is_cold:
                loop.step()
            loop.step()
    iters = []
    acts = [ProfilerActivity.CPU]
    if torch.device(system.device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(trace.WINDOW_SPAN):
            for _ in range(n):
                loop.step()
                iters.append(system.controller._last_iters)
    return trace.read_profile(prof, n), iters
