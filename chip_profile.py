#!/usr/bin/env python3
"""Where the port's staircase spends its time on one CUDA card.

    python3 chip_profile.py

For scene A (n=120) and scene B (n=1934) of ``chip_smoke.py`` through the
dense staircase, scene B through the implicit operator (``SchurQ``, the
mixed ladder on the two-float operator), and scene C (n=6144) through xm2's
``_solve_recover``: one untraced warm-up solve, one untraced timed solve,
and one solve under ``torch.profiler``.  Prints one JSON line per scene
with the untraced wall time, the traced wall time, the time the card was
busy (the union of its kernels' intervals), the idle share, the launches,
and the device time of the heaviest kernels by name.  Kernels are built
first, outside every timing.
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


def profile_solve(name, n, solve, set_up_s):
    """Warm-up, untraced and traced runs of ``solve()`` (a ``SolveResult``);
    returns the scene's JSON record."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    solve()                                                   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solve()
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
        scene=name, n=n, rank=res.rank, certified=bool(res.certified),
        primal=res.primal, **set_up_s, wall_s=wall,
        wall_traced_s=wall_traced, kernels=len(kernels),
        device_busy_s=(busy / 1e6 if kernels else "not measured"),
        idle_share=(1.0 - busy / 1e6 / wall_traced if kernels
                    else "not measured"),
        top_kernels_ms=[[k[:60], v / 1e3] for k, v in top],
        stages=list(res.stages))


def profile_dense(name, params, tol, dev):
    import chip_smoke as cs
    from xmtpu_torch.solver.staircase import solve_arrays

    C, t_gen, t_asm = cs.scene(params, dev)
    kw = dict(max_rank=6, tol=tol, precision="mixed", inner_f32=True,
              verbose=False, device=dev)
    return profile_solve(name, C.shape[0] // 3,
                         lambda: solve_arrays(C, **kw),
                         dict(make_scene_s=t_gen, assembly_s=t_asm))


def profile_implicit_b(dev):
    import torch

    import chip_smoke as cs
    from xmtpu_torch.ops.schurq import SchurQ
    from xmtpu_torch.pipeline.synthetic import make_scene
    from xmtpu_torch.solver.staircase import solve_arrays

    sc = make_scene(**cs.SCENE_B)
    t0 = time.perf_counter()
    Q = SchurQ.build(sc.weights, sc.edges, sc.landmarks, device=dev)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    kw = dict(max_rank=6, tol=1e-3, precision="mixed", inner_f32=True,
              edge_tf=True, verbose=False, device=dev)
    return profile_solve("B implicit", sc.N, lambda: solve_arrays(Q, **kw),
                         dict(build_s=t_build))


def profile_c(dev):
    import torch

    import chip_smoke as cs
    from xmtpu_torch.pipeline import xm2
    from xmtpu_torch.pipeline.synthetic import make_scene_window

    sc = make_scene_window(**cs.SCENE_C)
    t0 = time.perf_counter()
    Q, _, _ = xm2._assemble_operator(sc.weights, sc.edges, sc.landmarks,
                                     False, "auto", device=dev)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    return profile_solve("C", sc.N, lambda: xm2._solve_recover(
        Q, None, True, 5, 1e-1, 0.0, 1000.0, False, "mixed", device=dev)[0],
        dict(build_s=t_build))


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
        print(json.dumps(profile_dense(name, params, tol, dev)), flush=True)
    print(json.dumps(profile_implicit_b(dev)), flush=True)
    print(json.dumps(profile_c(dev)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
