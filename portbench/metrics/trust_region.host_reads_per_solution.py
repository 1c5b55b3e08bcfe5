"""Device-to-host reads of the trust region a traced solution:
``SolveResult.stages``' summed ``host_reads`` (the program's counter)
over the traced solutions."""

import pb_spans


def read(run):
    stages = pb_spans.stage_counters(run, "host_reads")
    res = [s for s in run.traced if s.result is not None]
    if not stages or not res:
        return None
    return sum(st["host_reads"] for st in stages) / len(res)
