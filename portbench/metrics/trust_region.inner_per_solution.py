"""Inner (tCG) iterations per solution: ``SolveResult.total_inner``, the
program's own counter, over the traced solutions."""


def read(run):
    res = [s.result for s in run.traced if s.result is not None]
    return sum(r.total_inner for r in res) / len(res) if res else None
