"""Inner (tCG) iterations per solution: ``SolveResult.total_inner``, the
program's own counter, summed over every solve of a request and over the
traced requests, per request."""

import pb_spans


def read(run):
    res = [r for r in map(pb_spans.results, run.traced) if r]
    if not res:
        return None
    return sum(x.total_inner for r in res for x in r) / len(res)
