"""Percent of the traced window idle while the trust region's spans
(``xm.tr.escape``, ``xm.tr.chunk.*``, ``xm.tr.tcg``) are the innermost
``xm.`` spans open: the host dispatching the trust-region loop."""

import pb_spans


def read(run):
    return pb_spans.idle_pct(run, "trust_region")
