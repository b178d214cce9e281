"""Share of the SQP loop's evaluations of the NLP that a CUDA graph's
replay served over the traced window: ``libmpc_tpu_torch/ops/sqp.py``'s
counts ``evals`` (every derivative block and merit evaluation of the loop)
and ``replays`` (those a replay served) at the window's start and at its
end, 100 times the difference of ``replays`` over that of ``evals``.  A
program without those counts, or a window without an evaluation, reports
nothing."""


def _counts():
    from libmpc_tpu_torch.ops import sqp

    evals, replays = getattr(sqp, "evals", None), getattr(sqp, "replays", None)
    return (evals, replays) if isinstance(evals, int) and isinstance(replays, int) else None


def open(run):
    return _counts()


def close(run, state):
    now = _counts()
    return None if state is None or now is None else (now[0] - state[0], now[1] - state[1])


def read(run, state=None):
    if state is None or not state[0]:
        return None
    return 100.0 * state[1] / state[0]
