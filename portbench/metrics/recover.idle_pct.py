"""Percent of the traced window idle while ``xm.recover`` (``recover_XM`` /
``recover_XM_implicit``) is the innermost ``xm.`` span open."""

import pb_spans


def read(run):
    return pb_spans.idle_pct(run, "recover")
