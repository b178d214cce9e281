"""The host's reads from the device, and the spans that name the port's layers.

Reads.  The solvers steer their loops from Python, so the host waits for the
device wherever a loop test, a count or an index set is read back.  Every
such read of the solver paths goes through this module, and each call adds
one to ``reads``, the number of reads since it was last set to 0 (a
measurement reads it per ``optimize`` or per window; nothing in the solvers
depends on it).  The count is kept on every device, so a CPU run counts the
reads the card would make.

* :func:`flag`: the boolean of a 0-d tensor (the loops' exit tests);
* :func:`values`: ``tolist()`` of a tensor (stacked counts and flags);
* :func:`nonzero`: the indices of a 1-D mask's true entries (the gathers of
  running or finished lanes; their size is read back);
* :func:`cholesky` and :func:`eigh`: the library factorizations, whose error
  check reads each matrix's status back.

Spans.  :func:`span` marks a layer of the port (``libmpc.<layer>.<part>``)
on the host timeline of a running ``torch.profiler``, the clock its device
activities share, so that a trace tells which layer the device waited for.
Without a profiler it returns a shared no-op context: the test costs about
0.1 us, where entering and leaving a ``record_function`` costs about 10 us.
A span never opens inside a function that ``torch.func`` transforms or that
a CUDA graph captures (a replay records no host span).
"""

from __future__ import annotations

import contextlib

import torch
from torch.profiler import record_function

reads = 0

_OFF = contextlib.nullcontext()
_profiling = torch._C._autograd._profiler_enabled


def span(name: str, args=None):
    """``record_function(name)`` while a profiler records (``args``, if
    given, shown beside it as text), a no-op context otherwise."""
    if _profiling():
        return record_function(name, None if args is None else str(args))
    return _OFF


def flag(t: torch.Tensor) -> bool:
    """The boolean value of a 0-d tensor, read on the host."""
    global reads
    reads += 1
    return bool(t)


def values(t: torch.Tensor):
    """``t.tolist()``: the tensor's values, read on the host."""
    global reads
    reads += 1
    return t.tolist()


def nonzero(mask: torch.Tensor) -> torch.Tensor:
    """The indices (k,) of the true entries of a 1-D mask; the host reads
    their count."""
    global reads
    reads += 1
    return torch.nonzero(mask)[:, 0]


def cholesky(M: torch.Tensor) -> torch.Tensor:
    """``torch.linalg.cholesky(M)``, which reads the factorization's status
    back to raise on a matrix that is not positive definite."""
    global reads
    reads += 1
    return torch.linalg.cholesky(M)


def eigh(H: torch.Tensor):
    """``torch.linalg.eigh(H)``, which reads the decomposition's status
    back."""
    global reads
    reads += 1
    return torch.linalg.eigh(H)
