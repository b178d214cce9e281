"""Device kernels a control step over the profiled sub-window (copies and
fills left out).  Each node of a replayed CUDA graph that the profiler
records is a kernel."""


def read(run, state=None):
    p = run.profile
    if p is None or p.steps == 0:
        return None
    return p.kernels() / p.steps
