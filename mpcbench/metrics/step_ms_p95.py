"""The 95th percentile, over every control step of the window, cold ones
included, of the wall milliseconds from the call of ``optimize`` to its
command being ready after ``torch.cuda.synchronize()``: what a control loop
waits each period."""

from mpcbench import stats


def read(run, state=None):
    return 1e3 * stats.percentile(run.window.step_s, 95)
