"""Percent of the traced window idle under ``xm.solve`` / ``xm.stage`` with
no deeper ``xm.`` span open: the staircase's own work between its trust
regions and certificates (the f32 cast, ranks' set-up, the copy-out)."""

import pb_spans


def read(run):
    return pb_spans.idle_pct(run, "staircase")
