"""Percent of the traced window idle under ``xm.xm2``, the whole of
``pipeline/xm2.xm2_solve``, with no deeper ``xm.`` span open: XM^2's own
work between its solves, builds and host stages (the probe's scale test,
the arrays' selections, the phases' synchronises).  With the other
``*.idle_pct`` lines and the idle time in no ``xm.`` span it partitions
``device.idle_pct``.  A program without the span gives none."""

import pb_spans

SPAN = "xm.xm2"


def read(run):
    sp = pb_spans.split(run)
    if sp is None or SPAN not in sp["spans"]:
        return None
    return 100.0 * sp["idle"].get(SPAN, 0) / sp["window_ns"]
