"""Seconds from the start of ``run.py`` to the first timed step: imports,
the kernels' build or load, the inputs made from the seed, and the warm-up
of every shape the cell uses."""


def read(run):
    return run.setup_s
