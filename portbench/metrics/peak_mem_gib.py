"""One problem's device memory in GiB: ``torch.cuda.max_memory_allocated()``
while its operator is built or one of its solutions runs, less what the
other scenes' operators hold (``run.Memory``)."""


def read(run):
    return run.problem_peak_bytes / 2**30 if run.problem_peak_bytes else None
