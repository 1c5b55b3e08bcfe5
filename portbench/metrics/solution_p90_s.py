"""The 90th percentile of the window's single-solution walls (host clock)."""

import statistics


def read(run):
    walls = [s.wall_s for s in run.solutions]
    if len(walls) < 2:
        return None
    print(f"[portbench] solution_p90_s over {len(walls)} solutions",
          flush=True)
    return statistics.quantiles(walls, n=10)[8]
