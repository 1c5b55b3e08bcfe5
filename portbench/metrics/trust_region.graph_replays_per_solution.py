"""Replays of the trust region's captured CUDA graphs a traced solution:
``SolveResult.stages``' summed ``graph_replays`` (the program's counter,
0 on the eager route) over the traced solutions.  A program without the
counter gives none."""

import pb_spans


def read(run):
    stages = pb_spans.stage_counters(run, "graph_replays")
    res = [s for s in run.traced if s.result is not None]
    if not stages or not res:
        return None
    return sum(st["graph_replays"] for st in stages) / len(res)
