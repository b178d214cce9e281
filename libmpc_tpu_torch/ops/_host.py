"""Reads of a flag from the device by the host-driven loops.

The SQP loop, the interior-point loop and the fused inner-QP solver's plain
twin steer their ``while`` loops from Python, so each loop test copies one
boolean from the device to the host and waits for the stream.  They all go
through :func:`flag`, which counts them: ``flag.reads`` is the number of such
reads since it was last set to 0 (a measurement script reads the count per
``optimize``; nothing in the solvers depends on it).
"""

from __future__ import annotations

import torch


def flag(t: torch.Tensor) -> bool:
    """The boolean value of a 0-d tensor, read on the host."""
    flag.reads += 1
    return bool(t)


flag.reads = 0
