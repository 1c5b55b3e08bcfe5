"""Kernels the profiler recorded in the traced part of the window, per
solution traced."""

import pb_trace


def read(run):
    if run.trace is None or not run.traced:
        return None
    n, _ = pb_trace.kernel_ns(run.trace, pb_trace.is_kernel)
    return n / len(run.traced)
