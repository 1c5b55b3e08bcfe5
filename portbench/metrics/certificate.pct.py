"""Percent of the staircase's time spent in the dual certificate:
``SolveResult.stages``' summed ``cert_s`` over summed ``stage_s + cert_s``,
over every solve of the traced requests."""

import pb_spans


def read(run):
    cert = total = 0.0
    for s in run.traced:
        for r in pb_spans.results(s):
            for st in r.stages:
                cert += st["cert_s"]
                total += st["stage_s"] + st["cert_s"]
    return 100.0 * cert / total if total else None
