"""Percent of a solution's wall spent in recovery: the benchmark's span
around ``recover_XM`` / ``recover_XM_implicit``, which ends in a
synchronise, over the traced solutions' walls."""


def read(run):
    total = sum(s.wall_s for s in run.traced)
    rec = sum(s.recover_s for s in run.traced)
    return 100.0 * rec / total if total else None
