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

    python3 chip_profile.py --kernels [ROOT ...]

times the kernels alone instead (:func:`kernel_times`), once for the
``xmtpu_torch`` of each ROOT in the order given (default: this checkout),
each in a process of its own, one JSON line each: an unpacked parent commit
and this checkout, given as ``parent . . parent``, compare on one card
(this checkout's ``chip_smoke.py`` times both; a tree without the
one-launch dense kernel is timed through its two).  Before them it prints
the card's probes, which

    python3 chip_profile.py --probe

prints alone (:func:`card_probe`: the dependent add's latency and an
empty launch, which ``chip_smoke.py`` also measures in every run for its
chain floors; the L2 and device-memory read rates, the L2's the source of
``chip_smoke.py``'s ``L2_READ_BYTES``).
    python3 chip_profile.py --assembly [ROOT ...]

times the dense assembly (:func:`assembly_times`) of scene A, scene B and
scene D's two XM^2 passes (their inputs made once, by this checkout, as
``chip_smoke.py`` phase 9 makes them: :func:`scene_d_assembly_inputs`),
and repeats scene A's assembly and staircase, for the ``xmtpu_torch`` of
each ROOT in its own process, one JSON line each, as ``--kernels`` does.
Imports nothing of JAX or of the JAX package.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np


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

    C, t_gen, t_asm = cs.scene(params, dev)[:3]
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


def _dense_times(cs, ft, inp, reps=200):
    """The dense variant's inner iteration on ``inp``: this tree's
    ``tcg_step_dense`` (one launch) or, where it is absent, the parent's
    ``tcg_cw_dense`` then ``tcg_step`` (found with ``hasattr``), timed as
    one iteration; with ``torch.matmul`` on the same W and ``tcg_step``
    alone as yardsticks."""
    import torch

    from xmtpu_torch.ops import manifold as mf

    n, _, o = inp["R"].shape
    max_inner = int(inp["cfg"].max_inner)
    _, const, state, sc, cfgsc = cs.step_inputs(inp)
    C32 = inp["qmul"].__self__.C.to(torch.float32).contiguous()
    ck = {k: v.clone() for k, v in const.items()}
    sk = [t.clone() for t in state]
    sck = sc.clone()
    reset = lambda: sck.copy_(sc)  # noqa: E731
    rec = dict(n=n, bound_ms=cs.bound_ms(*cs.dense_bytes_ops(n, o))[0],
               step_ms=cs.time_step(const, state, sc, cfgsc, max_inner,
                                    reps))
    Wf = mf.flatten(ft.from_t(sk[4] * ck["s_ex_t"] + ck["Rt"] * sk[5], n,
                              o)).contiguous()
    rec["matmul_ms"] = cs.device_ms(lambda: torch.matmul(C32, Wf), reps)
    if hasattr(ft, "tcg_step_dense"):
        rec["geometry"] = list(ft.dense_geometry(n, o))
        rec["dense_ms"] = cs.time_step(const, state, sc, cfgsc, max_inner,
                                       reps, C32=C32)
    else:
        cw = lambda: ft.tcg_cw_dense(  # noqa: E731
            C32, ck["Rt"], ck["s_ex_t"], sk[4], sk[5], sck, ck["CWt"],
            max_inner)
        rec["cw_ms"] = cs.device_ms(cw, reps)

        def pair():
            cw()
            ft.tcg_step(*ck.values(), *sk, sck, cfgsc, max_inner)
        rec["pair_ms"] = cs.device_ms(pair, reps, setup=reset)
    return rec


def _csr_inputs(Q, dev, order, D, dt):
    import torch

    ids, off, S = ((Q.l_l, Q.bounds_l, Q.n_landmarks) if order == "l"
                   else (Q.f_f, Q.bounds_f, Q.n_cameras))
    gen = torch.Generator().manual_seed(D)
    vals = torch.randn((ids.shape[0], D), generator=gen,
                       dtype=torch.float64).to(dt).to(dev)
    return vals, ids, off, S


# the sorted_segment_sum layouts of scene D's tail and last stage (E rows,
# S segments, the longest; the segments that hold rows; D), as chip_smoke.py
# records them from the main path; long_layout() draws lengths with that
# profile
LONG_LAYOUTS = {
    "BATA dst": (297_217, 7_581, 65, 7_581, (3,)),
    "BATA src": (297_217, 7_581, 2_543, 200, (3,)),
    "BA image": (258_811, 200, 2_358, 200, (6, 12, 36)),
    "BA track": (258_811, 7_381, 64, 7_381, (3, 9)),
    "BA camera": (200, 1, 200, 1, (6, 36)),
    "tri track": (297_217, 7_381, 65, 7_381, (1, 16)),
    "refine frame": (87_817, 200, 925, 200, (6,)),
    "refine landmark": (87_817, 4_366, 63, 4_366, (3,)),
}


def long_layout(E, S, longest, held, seed=0):
    """CSR offsets (S+1,) of E rows in S segments whose first ``held`` hold
    rows, one of them ``longest`` rows long, the others drawn evenly."""
    rng = np.random.default_rng(seed)
    L = np.zeros(S, np.int64)
    L[0] = longest
    if held > 1:
        L[1:held] = rng.multinomial(E - longest, np.full(held - 1,
                                                          1 / (held - 1)))
        L[1:held] = np.minimum(L[1:held], longest)
    L[0] += E - L.sum()
    return np.concatenate([[0], np.cumsum(rng.permutation(L))])


def card_probe(dev, cs) -> dict:
    """The card's numbers under ``chip_smoke.py``'s floors (module ``cs``),
    by ``csrc/probe.cu``: the chain floor's terms (``cs.measure_floors``:
    one dependent f32 and f64 add, an empty launch); the L2's read rate,
    the best over buffers that fit the 50 MB L2 (4 to 40 MB, each launch
    reading its buffer again and again, 1 GiB in all), grids of 1 to 16
    blocks an SM of 256 to 1024 threads (at most 2,048 threads an SM) and
    1, 4 or 8 loads in flight a thread; and device memory's, a 4 GiB
    buffer read once by the same grids.  Each rate is bytes over the CUDA
    events' time of 5 launches, with the best configuration."""
    import torch

    lib = cs.probe_lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = torch.zeros(4, dtype=torch.float64, device=dev)
    rec = dict(cs.measure_floors(dev))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    configs = [(b * sms, t, u) for t in (256, 512, 1024)
               for b in (1, 2, 4, 8, 16) if b * t <= 2048
               for u in (1, 4, 8)]

    def best_rate(nbytes, passes):
        buf = torch.empty(nbytes, dtype=torch.uint8, device=dev)
        best = (0.0, None)
        for blocks, threads, unroll in configs:
            ms = cs.cuda_ms(lambda: cs.launched(lib.xm_probe_read(
                buf.data_ptr(), nbytes // 16, passes, blocks, threads,
                unroll, out.data_ptr(), stream), "read"), 5)
            rate = nbytes * passes / (ms * 1e-3)
            if rate > best[0]:
                best = (rate, dict(blocks=blocks, threads=threads,
                                   unroll=unroll))
        return best

    rec["l2_by_size"] = {f"{mb} MB": best_rate(mb << 20, (1 << 30) // (
        mb << 20)) for mb in (4, 8, 16, 24, 32, 40)}
    rec["l2_read_bytes_s"] = max(r for r, _ in rec["l2_by_size"].values())
    rec["hbm_read"] = best_rate(4 << 30, 1)
    return rec


def long_times(dev, cs, ss) -> dict:
    """``sorted_segment_sum`` on :data:`LONG_LAYOUTS`, f64, for the
    ``segsum`` given (a parent tree's has no plan): device ms a launch
    beside ``index_add_``; where plans exist, the short-segment walk alone
    on the same offsets, and the kernel at other thresholds and stage
    sizes."""
    import torch

    res = {}
    for name, (E, S, longest, held, Ds) in LONG_LAYOUTS.items():
        off = long_layout(E, S, longest, held)
        ids = torch.as_tensor(np.repeat(np.arange(S), np.diff(off)),
                              device=dev)
        for D in Ds:
            gen = torch.Generator().manual_seed(D)
            vals = torch.randn((E, D), generator=gen,
                               dtype=torch.float64).to(dev)
            acc = torch.zeros((S, D), dtype=torch.float64, device=dev)

            def kernel(o):
                return cs.launch_ms(lambda: ss.sorted_segment_sum(
                    vals, ids, S, offsets=o), 50)

            plain = torch.as_tensor(off, dtype=torch.int32, device=dev)
            r = dict(library_ms=cs.launch_ms(
                lambda: acc.index_add_(0, ids, vals), 50))
            if not hasattr(ss, "planned_offsets"):
                r["ms"] = kernel(plain)
                res[f"{name} D={D}"] = r
                continue
            r["ms"] = kernel(ss.planned_offsets(off, dev, name))
            r["short_walk_ms"] = kernel(plain)
            keep = ss.CSR_LONG, ss.LONG_STAGE_BYTES, ss.LONG_WIDE_STAGE_BYTES
            for long_rows in (32, 64, 256, 512):
                ss.CSR_LONG = long_rows
                r[f"long_rows {long_rows}"] = kernel(
                    ss.planned_offsets(off, dev, name))
            ss.CSR_LONG = keep[0]
            for stage in (16384, 24576, 32768):
                ss.LONG_STAGE_BYTES = ss.LONG_WIDE_STAGE_BYTES = stage
                r[f"stage {stage}"] = kernel(ss.planned_offsets(off, dev,
                                                                name))
            ss.CSR_LONG, ss.LONG_STAGE_BYTES, ss.LONG_WIDE_STAGE_BYTES = keep
            res[f"{name} D={D}"] = r
    return res


def kernel_times(dev) -> dict:
    """For the ``xmtpu_torch`` first on ``sys.path``: ``tcg_step`` at scenes
    A, B and C (n = 120, 1934, 6144; o = 3, the first outer iteration of
    the f32 phase from identity frames, as ``chip_smoke.py`` holds them);
    the dense variant's iteration at n = 120, 512 and 1934 (scene B's C,
    above the gate) with ``torch.matmul`` and ``tcg_step`` beside it, and,
    where ``fused_tcg.dense_geometry`` exists, at other geometries; the
    segment sums on scene C's orderings as ``chip_smoke.py`` times them,
    and, where ``segsum.csr_threads`` exists, an empty kernel of each CSR
    case's grid and of a 256-thread grid (one thread an output), and the
    CSR kernel at other block sizes and batches (1 or 16); and the segment
    sum on scene D's tail and refine layouts (:func:`long_times`)."""
    import importlib.util

    import torch

    import xmtpu_torch
    from xmtpu_torch import _build
    from xmtpu_torch.ops import fused_tcg as ft
    from xmtpu_torch.ops import segsum as ss
    from xmtpu_torch.ops.qop import DenseQ, cast_qop
    from xmtpu_torch.ops import manifold as mf
    from xmtpu_torch.pipeline import xm2
    from xmtpu_torch.pipeline.synthetic import make_scene_window

    here = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(here, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    _build.build_all()
    f32 = torch.float32
    out = dict(root=os.path.dirname(os.path.dirname(
        os.path.abspath(xmtpu_torch.__file__))), step={}, dense={})
    ops = []
    for name, params in (("A", cs.SCENE_A), ("512", cs.SCENE_512),
                         ("B", cs.SCENE_B)):
        C = cs.scene(params, dev)[0]
        ops.append((name, DenseQ(C.to(f32)), C.shape[0] // 3))
        del C
    scC = make_scene_window(**cs.SCENE_C)
    Q_C, _, _ = xm2._assemble_operator(scC.weights, scC.edges, scC.landmarks,
                                       False, "auto", device=dev)
    ops.append(("C", cast_qop(Q_C, f32), scC.N))
    dense_geometry = getattr(ft, "dense_geometry", None)
    for name, q, n in ops:
        R = mf.identity_frames(n, 3, device=dev)
        ones = torch.ones((n,), dtype=torch.float64, device=dev)
        inp = cs.f32_phase_inputs(q, R, ones)
        if name != "512":
            _, const, state, sc, cfgsc = cs.step_inputs(inp)
            max_inner = int(inp["cfg"].max_inner)
            out["step"][name] = dict(
                n=n, ms=cs.time_step(const, state, sc, cfgsc, max_inner),
                bound_ms=cs.bound_ms(*cs.step_bytes_ops(n, 3))[0],
                geometry=list(ft.step_geometry(n, 3)))
        if name == "C":
            continue
        rec = _dense_times(cs, ft, inp)
        if dense_geometry is not None and name != "B":
            rec["sweep"] = {}
            keep = (ft.DENSE_CAMS_PER_BLOCK, ft.DENSE_THREADS)
            cams = (8, 16, 32, 64, 128) if n <= 128 else (32, 64, 128)
            for cpb in cams:
                for threads in (128, 256):
                    ft.DENSE_CAMS_PER_BLOCK, ft.DENSE_THREADS = cpb, threads
                    g = dense_geometry(n, 3)
                    _, const, state, sc, cfgsc = cs.step_inputs(inp)
                    C32 = ft.dense_matrix(inp["qmul"], n)
                    rec["sweep"][f"{g[0]}x{g[1]}"] = cs.time_step(
                        const, state, sc, cfgsc, int(inp["cfg"].max_inner),
                        C32=C32)
            ft.DENSE_CAMS_PER_BLOCK, ft.DENSE_THREADS = keep
        out["dense"][name] = rec
    del ops
    out["segsum"] = [dict(kernel=c["kernel"], tag=c["tag"], ms=c["ms"],
                          library_ms=c["library_ms"], bound_ms=c["bound"][0])
                     for c in cs.hold_segsum(Q_C, dev)]
    out["long"] = long_times(dev, cs, ss)
    if hasattr(ss, "csr_threads"):
        lib = ss._lib()
        stream = torch.cuda.current_stream(dev).cuda_stream
        out["csr_floor"], out["csr_sweep"] = {}, {}
        for order in ("l", "f"):
            for dt in (torch.float32, torch.float64):
                for D in (3, 6, 9, 18):
                    vals, ids, off, S = _csr_inputs(Q_C, dev, order, D, dt)
                    threads = ss.csr_threads(S, D)
                    grids = {"this": (-(-S * D // threads), threads, 0),
                             "256 a block": (-(-S * D // 256), 256, 0)}
                    out["csr_floor"][f"{order} {str(dt)[6:]} D={D}"] = {
                        k: cs.device_ms(lambda g=g: lib.xm_segsum_floor(
                            *g, stream), 100) for k, g in grids.items()}
        keep = (ss.CSR_THREADS, ss.csr_batch)
        f64 = torch.float64
        for order, dt, D in (("l", f32, 3), ("f", f32, 3), ("l", f32, 9),
                             ("l", f32, 18), ("f", f32, 18), ("l", f64, 18),
                             ("f", f64, 18)):
            vals, ids, off, S = _csr_inputs(Q_C, dev, order, D, dt)
            res = {}
            for threads in (64, 128, 256):
                for batch in (1, 16):
                    ss.CSR_THREADS = (threads,)
                    ss.csr_batch = lambda E, S, D, b=batch: b
                    res[f"{threads}t b{batch}"] = cs.device_ms(
                        lambda: ss.sorted_segment_sum(vals, ids, S,
                                                      offsets=off), 100)
            out["csr_sweep"][f"{order} {str(dt)[6:]} D={D}"] = res
            ss.CSR_THREADS, ss.csr_batch = keep
    return out


def scene_d_assembly_inputs(dev, cs) -> list:
    """Scene D's dense XM^2 assembly inputs as ``chip_smoke.py`` phase 9
    makes them (its database, the mapper, lifting with GT depth, then
    ``xm2_solve`` at its defaults): each pass's ``create_matrix_arrays``
    arguments ``(weights, edges, landmarks)``."""
    from xmtpu_torch.__main__ import main as cli
    from xmtpu_torch.pipeline import xm2
    from xmtpu_torch.pipeline.frontend import (build_view_graph, lift_dataset,
                                               parse_glomap_tempdata)

    sc = cs.make_scene_d(**cs.SCENE_D)
    with tempfile.TemporaryDirectory() as tmp:
        db, out = os.path.join(tmp, "database.db"), os.path.join(tmp, "out")
        cs.write_scene_d(db, sc)
        if cli(["mapper", "--database_path", db, "--output_path", out],
               device=dev) != 0:
            raise RuntimeError("scene D mapper failed")
        exp = parse_glomap_tempdata(out)
    vg = build_view_graph(exp.matches, N=exp.N, M=exp.M)
    lifted = lift_dataset(vg, lambda i: cs.scene_d_depth(sc, i),
                          lambda i: sc.K)
    with cs.recorded_calls(xm2, "create_matrix_arrays") as calls:
        cs.run_xm2_d(xm2, lifted, vg.N, vg.M, dev)
    return [a[:3] for a, _ in calls]


def assembly_times(dev, inputs: str, reps: int = 5) -> dict:
    """``create_matrix_arrays`` (f64) of the ``xmtpu_torch`` first on
    ``sys.path`` on scene A, scene B and scene D's two XM^2 passes (the
    arrays of the ``.npz`` file ``inputs``): after a warm-up, the
    synchronised walls of ``reps`` assemblies (ms, sorted), the
    ``sorted_segment_sum`` launches an assembly makes (0 where the tree
    sums with ``index_add_``), and whether the ``reps`` gave the same bits
    of C and Abar; then ``reps`` runs of scene A's assembly and mixed
    staircase as ``chip_smoke.py`` phase 3 runs them (wall, outer and
    inner iterations, primal bits), which vary as far as the assembly
    does."""
    import importlib.util

    import torch

    import xmtpu_torch
    from xmtpu_torch import _build
    from xmtpu_torch.assembly.creatematrix import create_matrix_arrays
    from xmtpu_torch.ops import segsum as ss
    from xmtpu_torch.pipeline.synthetic import make_scene
    from xmtpu_torch.solver.staircase import solve_arrays

    here = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(here, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    _build.build_all()
    cases = []
    for name, params in (("A", cs.SCENE_A), ("B", cs.SCENE_B)):
        sc = make_scene(**params)
        cases.append((name, (sc.weights, sc.edges, sc.landmarks)))
    with np.load(inputs) as d:
        for p in (1, 2):
            cases.append((f"D pass {p}", (d[f"w{p}"], d[f"e{p}"],
                                          d[f"l{p}"])))
    out = dict(root=os.path.dirname(os.path.dirname(
        os.path.abspath(xmtpu_torch.__file__))))
    for name, (w, e, l) in cases:
        def one():
            C, Abar = create_matrix_arrays(w, e, l, device=dev)
            torch.cuda.synchronize()
            return C, Abar

        one()
        n0 = ss.sorted_segment_sum.launches
        walls, first, same = [], None, True
        for _ in range(reps):
            t0 = time.perf_counter()
            got = one()
            walls.append((time.perf_counter() - t0) * 1e3)
            if first is None:
                first = got
            else:
                same = same and all(torch.equal(a, b)
                                    for a, b in zip(got, first))
            del got
        del first
        out[name] = dict(E=len(e), N=int(e[:, 0].max()),
                         M=int(e[:, 1].max()), wall_ms=sorted(walls),
                         median_ms=float(np.median(walls)),
                         segsum_launches=(ss.sorted_segment_sum.launches
                                          - n0) / reps,
                         same_bits=same)
    w, e, l = cases[0][1]
    out["A staircase"] = []
    for _ in range(reps):
        t0 = time.perf_counter()
        C, _ = create_matrix_arrays(w, e, l, device=dev)
        res = solve_arrays(C, max_rank=6, tol=1e-6, precision="mixed",
                           inner_f32=True, verbose=False, device=dev)
        torch.cuda.synchronize()
        out["A staircase"].append(dict(
            wall_s=time.perf_counter() - t0, rank=res.rank,
            outer=res.outer_iters, inner=res.total_inner,
            primal=float(res.primal).hex()))
        del C
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device available", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if sys.argv[1:2] in (["--kernels"], ["--probe"]):
        sys.path.insert(0, here)
        import chip_smoke as cs

        print(cs.card_line(), flush=True)
        print(json.dumps({"probe": card_probe(torch.device("cuda"), cs)}),
              flush=True)
        if sys.argv[1] == "--probe":
            return 0
        # each tree's kernels in a process of its own, in the order given
        for root in sys.argv[2:] or [here]:
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--kernels-in", os.path.abspath(root)],
                           check=True)
        return 0
    if sys.argv[1:2] == ["--assembly"]:
        sys.path.insert(0, here)
        import chip_smoke as cs
        from xmtpu_torch import _build

        _build.build_all()
        print(cs.card_line(), flush=True)
        calls = scene_d_assembly_inputs(torch.device("cuda"), cs)
        with tempfile.TemporaryDirectory() as tmp:
            npz = os.path.join(tmp, "scene_d_xm2.npz")
            np.savez(npz, **{f"{k}{p}": a for p, call in enumerate(calls, 1)
                             for k, a in zip("wel", call)})
            for root in sys.argv[2:] or [here]:
                subprocess.run([sys.executable, os.path.abspath(__file__),
                                "--assembly-in", os.path.abspath(root), npz],
                               check=True)
        return 0
    if sys.argv[1:2] == ["--assembly-in"]:
        sys.path.insert(0, sys.argv[2])
        print(json.dumps(assembly_times(torch.device("cuda"), sys.argv[3])),
              flush=True)
        return 0
    if sys.argv[1:2] == ["--kernels-in"]:
        sys.path.insert(0, sys.argv[2])
        dev = torch.device("cuda")
        print(json.dumps(kernel_times(dev)), flush=True)
        return 0
    sys.path.insert(0, here)
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
