"""Device-to-host reads a control step over the traced window: the port's
one count of them, ``libmpc_tpu_torch/ops/_host.py``'s ``reads`` (every
loop test, count, index gather and factorization status the solver paths
read back), at the window's start and at its end, the difference over the
window's steps.  A program without that count reports nothing."""


def _count():
    from libmpc_tpu_torch.ops import _host

    reads = getattr(_host, "reads", None)
    return reads if isinstance(reads, int) else None


def open(run):
    return _count()


def close(run, state):
    now = _count()
    return None if state is None or now is None else now - state


def read(run, state=None):
    if state is None or not run.window.steps:
        return None
    return state / run.window.steps
