"""Seconds from the process's start to the window's start: imports, the
kernels' load (or build), weights and inputs from the seed, warm-up."""


def read(run):
    return run.setup_s
