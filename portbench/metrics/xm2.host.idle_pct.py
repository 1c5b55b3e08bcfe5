"""Percent of the traced window idle while ``xm.xm2.host``, one of XM^2's
host stages over the observations (``pipeline/xm2.py``: each
``checklandmarks`` call, the residuals with the percentile cut), is the
innermost ``xm.`` span open.  A program without the span gives none."""

import pb_spans

SPAN = "xm.xm2.host"


def read(run):
    sp = pb_spans.split(run)
    if sp is None or SPAN not in sp["spans"]:
        return None
    return 100.0 * sp["idle"].get(SPAN, 0) / sp["window_ns"]
