"""Percent of the traced part of the window in which no device event ran."""

import pb_trace


def read(run):
    if run.trace is None or run.trace.w1 <= run.trace.w0:
        return None
    return 100.0 * (1.0 - pb_trace.busy_ns(run.trace)
                    / (run.trace.w1 - run.trace.w0))
