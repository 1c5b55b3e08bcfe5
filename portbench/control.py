"""Readings for the limits of ``correct``: the program's, and the control's.

    python3 portbench/control.py --workload <cell> --seeds 1 2 3 ...

For each seed this makes the cell's scenes, serves each once through its
route (as a run's window does), and judges them by the run's own
judgement (the route's ``judge``) against the float64 reference: the program's
outputs (the lower readings), and the control's, which is the reference
computed in float32 put in the program's place at the program's factors
(the upper readings).  One JSON line a seed.
The benchmark's runs do not run it; ``tests/test_pb_control.py`` runs it at
a small size.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
# the benchmark's modules, then the checkout's root, which holds the program
for _p in (os.path.dirname(HERE), HERE):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import pb_spec  # noqa: E402


def readings(cell: pb_spec.Cell, seed: int, device, control_dtype=None,
             log=print) -> dict:
    """``{"program": {...}, "control": {...}}``: the worst reading of each
    number over the scenes' solutions (the control's only with
    ``control_dtype``), judged by the run's own judgement, its route's
    ``judge``."""
    route = pb_spec.load_route(cell)
    config = cell.config
    scenes = route.scenes(config)
    held = [route.setup(sc, config, device) for sc in scenes]
    sols = [route.request(k, h, config, device)
            for k, h in enumerate(held)]
    for s in sols:
        r = s.result
        if r is not None:
            log(f"[control] seed {seed} scene {s.scene}: rank {r.rank} "
                f"outer {r.outer_iters} inner {r.total_inner} wall "
                f"{s.wall_s:.3f} s")
    prog, failed, ctrl = route.judge(scenes, held, sols, config, seed,
                                     device, control_dtype, log=log)
    out = {"seed": seed, "walls": [s.wall_s for s in sols],
           "program": dict(prog, failed=failed)}
    if control_dtype is not None:
        out["control"] = dict(ctrl, failed=failed)
    return out


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    cell = pb_spec.find_cell(args.workload, pb_spec.load_benchmark())
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    import pb_program

    pb_program.build_kernels()
    for seed in args.seeds:
        print(json.dumps(readings(cell, seed, torch.device("cuda", 0),
                                  torch.float32,
                                  log=lambda *a: print(*a, flush=True))),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
