"""Seconds from the start of the process to the first timed step: imports,
the card check, loading (and on a checkout's first run building) the kernel
library, building the controller and the warm-up."""


def read(run, state=None):
    return run.setup_s
