"""Lane-solves completed in the window over the window's wall seconds: one
lane's ``optimize`` at one control step is one solve; cold steps, warm steps
and the plant all fall inside the window's time."""

from mpcbench import stats


def read(run, state=None):
    return stats.rate(run.window.attempted, run.window.wall_s)
