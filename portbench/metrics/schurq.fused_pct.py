"""Share of the implicit operator's products that ran as the fused float32
kernels (``ops/schurq.py`` ``schurq_product``) in the traced solutions:
``SolveResult.stages``' summed ``applies_fused`` over the summed
``applies_f64``, ``applies_tf`` and ``applies_f32``, in percent.  None where
the runs made no ``SchurQ`` product, or the program has no
``applies_fused`` counter."""

import pb_spans

ALL = ("applies_f64", "applies_tf", "applies_f32")


def read(run):
    stages = pb_spans.stage_counters(run, "applies_fused")
    total = sum(st[k] for st in stages for k in ALL)
    if not total:
        return None
    return 100.0 * sum(st["applies_fused"] for st in stages) / total
