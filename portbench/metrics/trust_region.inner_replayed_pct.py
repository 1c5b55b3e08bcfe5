"""Share of the inner (tCG) iterations that ran inside a replayed CUDA
graph of the f64 tCG loop (``solver/graph_step.InnerGraphs``) in the traced
solutions: ``SolveResult.stages``' summed ``inner_replayed`` over the summed
``SolveResult.total_inner``, in percent.  None where the runs made no inner
iteration, or the program has no ``inner_replayed`` counter."""

import pb_spans


def read(run):
    stages = pb_spans.stage_counters(run, "inner_replayed")
    total = sum(r.total_inner for s in run.traced
                for r in pb_spans.results(s))
    if not stages or not total:
        return None
    return 100.0 * sum(st["inner_replayed"] for st in stages) / total
