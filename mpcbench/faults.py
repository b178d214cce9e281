"""Faults planted in the timed path, for the tests and readings that show
a broken program comes out not correct.

Each function takes the :class:`~mpcbench.loop.System` a builder returned
and wraps its controller's ``optimize`` as the window calls it:

* :func:`stale`: a step returns the controller's previous result unchanged;
* :func:`half`: half of the batch is left out, its commands the mean of the
  other half's;
* :func:`altered`: one lane's command is altered where it is produced.

No cell runs on more than one card, so the fault of an exchange between
cards left out has no cell to plant it in.
"""

from __future__ import annotations

import dataclasses

ALTER = 0.5  # an altered command's change


def stale(system):
    c, orig, first = system.controller, system.controller.optimize, {}

    def optimize(x, u):
        r = orig(x, u)  # the work is done, its result dropped
        first.setdefault("r", r)
        return first["r"]

    c.optimize = optimize


def half(system):
    c, orig = system.controller, system.controller.optimize

    def optimize(x, u):
        r = orig(x, u)
        h = r.cmd.shape[0] // 2
        cmd = r.cmd.clone()
        cmd[h:] = r.cmd[:h].mean(dim=0)
        return dataclasses.replace(r, cmd=cmd)

    c.optimize = optimize


def altered(system, by=ALTER):
    c, orig, step = system.controller, system.controller.optimize, [0]

    def optimize(x, u):
        r = orig(x, u)
        cmd = r.cmd.clone()
        cmd[step[0] % cmd.shape[0], 0] += by
        step[0] += 1
        return dataclasses.replace(r, cmd=cmd)

    c.optimize = optimize


FAULTS = {"stale": stale, "half": half, "altered": altered}
