"""Seconds from process start to the first timed solution: imports, CUDA
init, the kernels' load (or build), scenes, operators and warm-up."""


def read(run):
    return run.setup_s
