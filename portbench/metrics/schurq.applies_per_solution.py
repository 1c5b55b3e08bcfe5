"""Products of the implicit operator a traced solution:
``SolveResult.stages``' summed ``applies_f64``, ``applies_tf`` and
``applies_f32`` (the program's counters: the exact ``SchurQ``, the
two-float ``SchurQTF``, and those in float32 arithmetic) over the traced
solutions.  A program without the counters gives none."""

import pb_spans

KEYS = ("applies_f64", "applies_tf", "applies_f32")


def read(run):
    stages = pb_spans.stage_counters(run, KEYS[0])
    res = [s for s in run.traced if s.result is not None]
    if not stages or not res:
        return None
    return sum(st[k] for st in stages for k in KEYS) / len(res)
