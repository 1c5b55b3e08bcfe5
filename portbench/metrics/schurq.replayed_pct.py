"""Share of the implicit operator's products that ran inside a replayed
CUDA graph of the f32 outer step (``solver/graph_step.py``) in the traced
solutions: ``SolveResult.stages``' summed ``applies_replayed`` over the
summed ``applies_f64``, ``applies_tf`` and ``applies_f32``, in percent.
None where the runs made no ``SchurQ`` product, or the program has no
``applies_replayed`` counter."""

import pb_spans

ALL = ("applies_f64", "applies_tf", "applies_f32")


def read(run):
    stages = pb_spans.stage_counters(run, "applies_replayed")
    total = sum(st[k] for st in stages for k in ALL)
    if not total:
        return None
    return 100.0 * sum(st["applies_replayed"] for st in stages) / total
