"""Percent of the traced window idle while ``xm.schurq.build``, the build of
the implicit operator (``ops/schurq.py`` ``SchurQ.build``: its host sorts,
segment sums and ``VT_inv``), is the innermost ``xm.`` span open.  A program
without the span, or a window in which no operator was built, gives none."""

import pb_spans

SPAN = "xm.schurq.build"


def read(run):
    sp = pb_spans.split(run)
    if sp is None or SPAN not in sp["spans"]:
        return None
    return 100.0 * sp["idle"].get(SPAN, 0) / sp["window_ns"]
