"""Wall seconds per certified solution: the window's length over the
solutions it served (host clock)."""


def read(run):
    return run.window_s / len(run.solutions) if run.solutions else None
