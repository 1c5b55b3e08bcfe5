#!/usr/bin/env python3
"""Where the port's staircase spends its time on one CUDA card.

    python3 chip_profile.py

For scene A (n=120) and scene B (n=1934) of ``chip_smoke.py``: one
untraced warm-up solve, one untraced timed solve, and one solve under
``torch.profiler``.  Prints one JSON line per scene with the untraced wall
time, the traced wall time, the time the card was busy (the union of its
kernels' intervals), the idle share, the launches, and the device time of the
heaviest kernels by name.  Kernels are built first, outside every timing.
Imports nothing of JAX or of the JAX package.
"""

import json
import os
import sys
import time


def busy_us(intervals) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def profile_scene(name, params, tol, dev):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from xmtpu_torch.solver.staircase import solve_arrays

    C, t_gen, t_asm = cs.scene(params, dev)
    kw = dict(max_rank=6, tol=tol, precision="mixed", inner_f32=True,
              verbose=False, device=dev)
    solve_arrays(C, **kw)                                     # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solve_arrays(C, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solve_arrays(C, **kw)
        torch.cuda.synchronize()
        wall_traced = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end
                                                      - e.time_range.start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    busy = busy_us([(e.time_range.start, e.time_range.end) for e in kernels])
    return dict(
        scene=name, n=C.shape[0] // 3, rank=res.rank,
        certified=bool(res.certified), primal=res.primal,
        make_scene_s=t_gen, assembly_s=t_asm, wall_s=wall,
        wall_traced_s=wall_traced, kernels=len(kernels),
        device_busy_s=(busy / 1e6 if kernels else "not measured"),
        idle_share=(1.0 - busy / 1e6 / wall_traced if kernels
                    else "not measured"),
        top_kernels_ms=[[k[:60], v / 1e3] for k, v in top],
        stages=list(res.stages))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke as cs
    from xmtpu_torch import _build

    _build.build_all()
    dev = torch.device("cuda")
    print(cs.card_line(), flush=True)
    for name, params, tol in (("A", cs.SCENE_A, 1e-6),
                              ("B", cs.SCENE_B, 1e-3)):
        print(json.dumps(profile_scene(name, params, tol, dev)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
