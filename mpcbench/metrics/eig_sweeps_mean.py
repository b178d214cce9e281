"""Mean Jacobi sweeps a lane, over every K6 launch of the traced window, from
the eigenvalue clipping's counter
``libmpc_tpu_torch/ops/batched_linalg.py::eig_clip.trace`` (each launch's
per-lane sweep counts, a device tensor, read only once the window has
closed).  A program without that counter, or a window without a launch,
reports nothing."""

import torch


def _counter():
    from libmpc_tpu_torch.ops import batched_linalg

    fn = getattr(batched_linalg, "eig_clip", None)
    return fn if fn is not None and hasattr(fn, "trace") else None


def open(run):
    fn = _counter()
    if fn is None:
        return None
    fn.trace = []
    return fn.trace


def close(run, state=None):
    """The window's per-lane sweep counts, one tensor on the host; the
    counter stopped."""
    fn = _counter()
    if fn is None or state is None:
        return None
    fn.trace = None
    return (torch.cat([s.reshape(-1) for s in state]).cpu() if state
            else torch.zeros(0, dtype=torch.int32))


def read(run, state=None):
    return None if state is None or state.numel() == 0 else float(state.double().mean())
