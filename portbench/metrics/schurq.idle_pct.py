"""Percent of the traced window idle while ``xm.schurq.apply``, one product
of the implicit operator (``ops/schurq.py``), is the innermost ``xm.`` span
open.  With it, the trust region's, the certificate's, the recovery's and
the staircase's idle shares and the idle time in no ``xm.`` span partition
``device.idle_pct``.  A program without the span gives none."""

import pb_spans

SPAN = "xm.schurq.apply"


def read(run):
    sp = pb_spans.split(run)
    if sp is None or SPAN not in sp["spans"]:
        return None
    return 100.0 * sp["idle"].get(SPAN, 0) / sp["window_ns"]
