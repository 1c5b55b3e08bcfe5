"""Percent of the traced window idle while ``xm.cert``, the dual
certificate, is the innermost ``xm.`` span open."""

import pb_spans


def read(run):
    return pb_spans.idle_pct(run, "certificate")
