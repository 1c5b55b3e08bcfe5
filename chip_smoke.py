#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``xmtpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase is caught):

1. build the CUDA kernels from ``xmtpu_torch/csrc`` (nvcc, all at once);
2. hold each kernel against its plain PyTorch version on the card, on real
   f32-phase inputs (the first outer iteration of a stage, and one later in
   the phase where the Steihaug loop runs long): one inner iteration, two
   launches of it on the same inputs that must give the same bits, and a
   whole Steihaug loop; time both versions beside the kernel's bound and
   print the launch geometry (``fused_tcg.step_geometry``, or
   ``dense_geometry`` for ``tcg_step_dense``, which the dense cases also
   time beside ``torch.matmul`` on the same W and ``tcg_step`` alone);
3. scene A (n=120, the saddle-escape anchor): dense assembly on the card and
   the mixed certified staircase, which must certify at rank 4 through the
   dense kernel variant — one ``tcg_step_dense`` launch for each inner
   iteration the fused loops enqueue, no ``tcg_step`` — and match the
   port's own CPU run;
4. scene B (n=1934): the same through the split variant, certified at
   rank 3;
5. scene C (n=6144, the implicit size): ``xm2._assemble_operator`` must pick
   the implicit ``SchurQ``; both segment-sum kernels are held against their
   plain twin on its real orderings (landmark and frame, D in {3, 6, 9, 18},
   f32 and f64, the blocked one on ``schedule_edges``' layout of the landmark
   ordering), two launches must give the same bits, and each is timed beside
   its bound and ``index_add_``, the CSR kernel also bit for bit against the
   CPU twin; then ``tcg_step`` is held as in phase 2 at
   n=6144 (the split variant on the f32 cast of ``Q_C``, the f64 loop on
   ``Q_C``), at the phase's first outer iteration and at ``LONG_C``;
6. scene B through ``SchurQ`` (the mixed ladder on the two-float operator,
   the matvec certificate): certified at rank 3 within 5e-3 of the
   reference's primal; before it, the same operator built on the host and
   moved to the card must apply through the segment-sum kernel (exact, f32
   cast and two-float), with the same bits on two applies;
7. scene C through ``xm2._solve_recover`` at xm2's defaults: certified at
   rank 3 within 5e-3 of the reference's primal, recovered rotations no
   worse than 1.5x the reference's errors, segment-sum and tcg_step
   launches > 0; then a second, traced solve gives ``tcg_step``'s mean
   device time inside the solve (``solve_ms``);
8. ``xm2_solve(implicit=True)`` on scene B: its phases, and rotation errors
   no worse than 1.5x the reference's;
9. scene D (200 frames on a loop in a room, matched exhaustively, 5 % of
   the pairs corrupted; ``make_scene_d``) written as a COLMAP database:
   ``python -m xmtpu_torch mapper`` twice through ``__main__.main`` (equal
   tempdata files; images, valid pairs, tracks and observations equal to
   the JAX package's; every corrupted pair dropped, no clean one; ``R_rel``
   within 1e-4 of GT), the launches and host reads of one ``filter_pairs``
   call; ``filter_pairs`` on every stored pair with the rotations
   decomposed from their E (mask = the clean pairs, twice; its loops'
   iterations, launches and host reads); lifting with GT depth,
   ``xm2_solve`` at its defaults (dense) and implicit at tol 1e-4
   (``sorted_segment_sum`` launched), each certified at the JAX package's
   rank within 5e-3 of its primal and 1.5x its rotation errors; the
   implicit route at its default tol certified at the rank of the dense
   route on its observations at the lam it picked, within 5e-3 of that
   primal; and ``calibrate_view_graph`` within 1 % of the focal and 1e-6
   of the JAX package's; per-stage seconds and the phase's device memory
   peak above what it started with;
10. print the kernels' JSON line, the card's name and power limit, and the
   contract line ``{"ok": true, "device": {...}}`` last.

A kernel's ``ms`` is its time on the card per launch (profiler durations);
``enqueue_ms`` is the rate at which back-to-back calls of its Python wrapper
complete (CUDA events), which the host bounds at these sizes; ``plain_ms``
is the plain version's time per call by CUDA events, its host syncs
included; ``bound_ms`` is the larger of the bytes it must move over the
HBM rate and its operations over the f32 (f64) peak; ``library_ms`` is the
card's time for ``torch.matmul`` on the same W (the dense variant's
product) or for one ``index_add_`` on the same tensors (segment sums, whose
plain twin is ``zeros`` + ``index_add_``).  Each kernel's ``launches`` sums
its counter over the main-path runs of phases 3, 4, 6, 7, 8 and 9, each read
just after its run with the counters set to 0 just before; the segment
sum's launches are also counted by dtype and D (its ``shapes``), and its
row on the ``kernels`` line shows the most launched shape, f32 D=3 on the
landmark ordering.

Imports nothing of JAX or of the JAX package.
"""

import json
import os
import subprocess
import sys
import time
from typing import NamedTuple

import numpy as np

# scene A, the repository's saddle-escape anchor: rank 3 refuted, rank 4
# certified at this primal (tests/test_scale.py, rtol 1e-4 as there)
SCENE_A = dict(n_cameras=120, n_points=400, obs_per_camera=10, noise=0.35,
               seed=1)
PRIMAL_A = 66.46483
# scene B, the n=1934 testbed (bench.py's _scale_metric shapes).  Reference
# value: the JAX package on the CPU at commit 7924370,
# solve_arrays(create_matrix_arrays(...)[0], max_rank=6, tol=1e-3,
# precision="mixed", inner_f32=True) -> certified rank 3, 77 outer / 294
# inner, lam_min -4.6e-13, primal 0.3741873841357
SCENE_B = dict(n_cameras=1934, n_points=7736, obs_per_camera=60, noise=1e-3,
               seed=0)
PRIMAL_B = 0.3741873841357
# scene B through the implicit operator.  Reference value: the JAX package
# on the CPU at commit 0f67b61, solve_arrays(SchurQ.build(...),
# max_rank=6, tol=1e-3, precision="mixed", inner_f32=True, edge_tf=True)
# -> certified rank 3, 117 outer / 338 inner, lam_min 1.1e-5
PRIMAL_B_IMPLICIT = 0.3742101204813012
# scene C, the implicit size (benchmarks/n6k_bench.py's scene): E = 270,336
SCENE_C = dict(n_cameras=6144, n_points=24576, obs_per_camera=40,
               noise=1e-3, seed=0, long_range=4)
# reference values, the JAX package on the CPU at commit 0f67b61:
# xm2._solve_recover(xm2._assemble_operator(..., implicit="auto",
# precision="mixed"), None, True, 5, 1e-1, 0.0, 1000.0, ..., "mixed") ->
# certified rank 3, 248 outer / 3230 inner, and the recovered rotations'
# errors against R_gt (radians, gauge-fixed to camera 0)
PRIMAL_C = 0.8487572611415747
ROT_C = dict(max=0.0005336820037861338, mean=0.00014647454844549592)
# xm2_solve(scene B, implicit=True) at its defaults, same commit: the final
# rotations' errors against R_gt
ROT_XM2_B = dict(max=0.0012587838027017166, mean=0.00011281938882602603)
RTOL_IMPLICIT = 5e-3
ROT_SLACK = 1.5
# the dense anchor of scene B, printed beside the implicit run's primal
DENSE_ANCHOR_B = 0.3741873841357
# the largest scene the dense variant's gate admits (n <= 512)
SCENE_512 = dict(n_cameras=512, n_points=2048, obs_per_camera=60, noise=1e-3,
                 seed=0)
RTOL_PRIMAL = 1e-4
# f32-phase outer iterations after which the Steihaug loop runs long (on
# the host: 54 iterations at scene A, 12 at scene B)
LONG_A, LONG_B = 85, 56
# the same at scene C on the f32 cast of SchurQ: 20 iterations after 104
# outer ones, 11-25 at every index from 95 to 119 (chip_profile.py
# --kernels, H100)
LONG_C = 104
LONG_C_ITERS = 10  # the fewest inner iterations the case must run

# scene D, a Replica-scale sequence matched exhaustively (the reference
# driver's pycolmap.match_exhaustive; Replica room sequences): a closed loop
# of frames in a room, a two-view geometry for every pair that shares enough
# points, 5 % of them corrupted; the mapper, lifting with GT depth and XM^2
SCENE_D = dict(n_frames=200, n_points=8000, seed=0)
SCENE_D_ROOM = (10.0, 8.0, 3.0)       # x, y, z extent (m), floor at z = 0
SCENE_D_LOOP = dict(rx=2.5, ry=2.0, height=1.5, sway=0.6, sway_cycles=3)
# the Replica camera: SIMPLE_PINHOLE 1200 x 680, prior focal kept
SCENE_D_CAMERA = dict(width=1200, height=680, f=600.0, cx=599.5, cy=339.5)
SCENE_D_MIN_SHARED = 50               # points a pair shares to be stored
SCENE_D_PIXEL_NOISE = 0.5             # keypoint noise (px)
SCENE_D_BAD = dict(share=0.05, deg=(20.0, 40.0))  # corrupted relative poses
# reference values: the JAX package on the CPU at commit 872ab1b, same
# generator and seed.  ``python -m xmtpu mapper --database_path D
# --output_path T`` on write_scene_d's database: images with observations in
# output.txt, lines of relative_pose.txt, tracks, observations
MAPPER_D = dict(registered=200, valid_pairs=7950, n_tracks=7381,
                n_obs=297217)
# then parse_glomap_tempdata(T) -> build_view_graph -> lift_dataset(GT depth
# of scene_d_depth) -> xm2_solve(..., verbose=False, **XM2_D_ARGS[route]):
# the last staircase solve's certified rank and primal, and the rotation
# errors of the result against GT.  The implicit route is held at tol=1e-4,
# where its stages run in f64: at the default tol=1e-1 (and at 1e-3) the f32
# and two-float stages stop at their noise floor, where the libraries'
# orders part, and on scene D that flips the rank-3 probe's scale test
# (|s_avg - 1| vs 2 std at std 1.5e-4), hence lam, rank and primal.  On the
# CPU the port takes the JAX package's branch at the default tol (lam 0,
# certified rank 3 at 6.666298070003821, commit fac41b7).  The default-tol
# run is held against the dense route at the lam it picked
# (hold_default_tol) and printed beside XM2_D_DEFAULT and XM2_D_FORCED
XM2_D_ARGS = dict(dense={}, implicit=dict(implicit=True, tol=1e-4))
XM2_D = dict(
    dense=dict(rank=4, primal=6.66350697353551,
               rot=dict(max=0.0009281971801524574,
                        mean=0.0005249496173795711)),
    implicit=dict(rank=4, primal=6.663506976056988,
                  rot=dict(max=0.0009281347632745869,
                           mean=0.0005249035385708607)))
XM2_D_DEFAULT = dict(rank=3, primal=6.665356859005428, lam=0.0,
                     rot=dict(max=0.0013050636879244804,
                              mean=0.0007242564219372327))
# the JAX package's default-tol implicit run with pass 2's final
# _solve_recover given lam = |E| / N of its observations (the branch its
# probe declined), at commit fac41b7: certified rank 4
XM2_D_FORCED = dict(rank=4, primal=6.777635902752089, lam=1337.475)
# calibrate_view_graph(*scene_d_calibration_inputs(scene D),
# prior_mask=[False]) -> focal
CALIB_D = 600.0000000000765

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s and f32 /
# f64 FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PEAK_F64 = 34e12
F32 = 4  # bytes


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, setup=None) -> float:
    """Mean ms per call of ``fn`` by CUDA events over ``reps`` back-to-back
    calls, minus the time of ``setup`` alone when given (it runs before every
    call).  Where the host cannot enqueue as fast as the card runs, this is
    the enqueue rate, not the kernel's time: see :func:`device_ms`."""
    import torch

    def run(with_fn):
        for _ in range(3):
            if setup:
                setup()
            if with_fn:
                fn()
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(reps):
            if setup:
                setup()
            if with_fn:
                fn()
        t1.record()
        t1.synchronize()
        return t0.elapsed_time(t1) / reps

    base = run(False) if setup else 0.0
    return max(run(True) - base, 0.0)


def device_ms(fn, reps: int, setup=None) -> float:
    """Mean ms per call of the card's own work in ``fn``: the durations of
    the kernels and copies it issues, as ``torch.profiler`` records them,
    minus those of ``setup`` alone when given.  Host gaps between launches
    do not count.  ``fn`` and ``setup`` each launch at least one kernel or
    copy a call; a traced run that recorded fewer than ``reps`` of them (the
    profiler now and then drops a whole run's events) is taken again, and
    five such runs in a row raise."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def busy_us(with_fn):
        for _ in range(5):
            for _ in range(3):
                if setup:
                    setup()
                if with_fn:
                    fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    if setup:
                        setup()
                    if with_fn:
                        fn()
                torch.cuda.synchronize()
            ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
            if len(ev) >= reps:
                return sum(e.time_range.end - e.time_range.start for e in ev)
        raise RuntimeError(f"device_ms: the profiler recorded {len(ev)} "
                           f"device events over {reps} calls, five times")

    base = busy_us(False) if setup else 0.0
    return max(busy_us(True) - base, 0.0) / reps / 1e3


def kernel_mean_ms(fn, name: str):
    """Runs ``fn`` once under ``torch.profiler``: the mean device ms of the
    kernels whose name holds ``name``, and their count."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = [e.time_range.end - e.time_range.start for e in prof.events()
          if e.device_type == DeviceType.CUDA and name in e.name]
    if not ev:
        raise RuntimeError(f"kernel_mean_ms: no device event named {name}")
    return sum(ev) / len(ev) / 1e3, len(ev)


def f32_phase_inputs(q, R, s_ex, outer: int = 0, lam=0.0):
    """Real inputs of ``fused_tcg.inner_tcg_fused`` on the f32 operator
    ``q``: the mixed ladder's f32 phase started at (R, s_ex) is run for
    ``outer`` outer iterations, and its next outer iteration's tCG arguments
    are computed as ``_outer_step`` does (``outer=0``: the phase's first
    outer iteration)."""
    import torch

    from xmtpu_torch.ops import manifold as mf
    from xmtpu_torch.solver import trust_region as tr

    f32 = torch.float32
    n, _, o = R.shape
    cfg32, gradtol32 = tr.TRConfig().f32_ladder(1e-6)
    delta_bar = np.float32(np.sqrt(float(n * (3 * o - 6) + n - 1)))
    st = tr._init_state(q, R.to(f32), s_ex.to(f32), np.float32(lam),
                        delta_bar, cfg32)
    st = tr._run_chunk(q, st, lam, gradtol32, delta_bar, cfg32, outer)
    R, s_ex = st.R, st.s_ex
    egR, egs, CsR = mf.egrad_csr(q.apply, R, s_ex, lam)
    pgR, pgs = mf.project(R, s_ex[1:], egR, egs)
    gradnorm = np.float32(torch.sqrt(
        mf.inner(pgR, pgR, pgs, pgs, s_ex[1:])).item())
    minv = tr._build_minv(q.diag_blocks(), s_ex, np.float32(lam))
    return dict(qmul=q.apply, R=R, s_ex=s_ex, CsR=CsR, egR=egR, egs=egs,
                pgR=pgR, pgs=pgs, gradnorm=gradnorm, delta=st.delta,
                lam=np.float32(lam), cfg=cfg32, minv=minv)


def step_bytes_ops(n: int, o: int):
    """Bytes one tcg_step must move (inputs read once, outputs written
    once) and the f32 operations it does, from the kernel's arithmetic."""
    blk, row = 3 * o * n, n
    reads = 3 * blk + 5 * row + 2 * 9 * n + 8 + 4      # const arrays, sc, cfg
    state = 4 * blk + 4 * row                           # read and written
    nbytes = F32 * (reads + 2 * state + 8)
    ops = n * (183 * o + 40)
    return nbytes, ops


def cw_bytes_ops(n: int, o: int):
    """The dense variant's product alone: C, W's inputs, CW out."""
    m = 3 * n
    nbytes = F32 * (m * m + 2 * 3 * o * n + 2 * n + 8 + 3 * o * n)
    ops = 2 * m * m * o + 3 * 3 * o * n
    return nbytes, ops


def dense_bytes_ops(n: int, o: int):
    """One ``tcg_step_dense``: ``tcg_step``'s bytes with C read once more
    (W's inputs are already among them, CWt now written instead of read),
    and both operation counts."""
    m = 3 * n
    sb, so = step_bytes_ops(n, o)
    cb, co = cw_bytes_ops(n, o)
    return sb + F32 * m * m, so + co


def bound_ms(nbytes, ops, peak_ops=PEAK_F32):
    tb, to = nbytes / PEAK_BYTES * 1e3, ops / peak_ops * 1e3
    return max(tb, to), ("bytes" if tb >= to else "operations")


def assert_close(name, got, want, atol, rtol):
    """Fails unless ``|got - want| <= atol + rtol |want|`` everywhere;
    returns the largest error, absolute and relative to ``max |want|``."""
    import torch

    err = (got - want).abs()
    lim = atol + rtol * want.abs()
    bad = int((err > lim).sum())
    if bad or not bool(torch.isfinite(got).all()):
        raise AssertionError(
            f"{name}: {bad} entries beyond atol={atol:.2e} rtol={rtol:.0e} "
            f"(max err {float(err.max()):.3e})")
    return float(err.max()), float(err.max()) / max(float(want.abs().max()),
                                                    1e-30)


def worst(errs):
    """(largest absolute, largest relative) of ``assert_close`` results."""
    return max(e[0] for e in errs), max(e[1] for e in errs)


def f64_loop(q, inp):
    """The Steihaug loop of ``inp`` in float64 through the generic path, on
    the f64 operator ``q``: ``(vR, vs, hvR, hvs, endreason, iters)``."""
    import torch

    from xmtpu_torch.ops import manifold as mf
    from xmtpu_torch.solver import trust_region as tr

    R, s_ex = inp["R"].double(), inp["s_ex"].double()
    lam = float(inp["lam"])
    egR, egs, CsR = mf.egrad_csr(q.apply, R, s_ex, lam)
    pgR, pgs = mf.project(R, s_ex[1:], egR, egs)
    minv = tr._build_minv(q.diag_blocks(), s_ex, np.float64(lam))
    gradnorm = float(torch.sqrt(mf.inner(pgR, pgR, pgs, pgs, s_ex[1:])))
    return tr._inner_tcg(q.apply, R, s_ex, CsR, egR, egs, pgR, pgs, gradnorm,
                         float(inp["delta"]), np.float64(lam), inp["cfg"],
                         minv=minv)


def rel_gap(a, b) -> float:
    """Largest gap between the arrays of two loop results, each relative to
    the largest entry of its array in ``b``."""
    return max(float((x.double() - y.double()).abs().max())
               / max(1e-3, float(y.abs().max())) for x, y in zip(a[:4], b[:4]))


def step_inputs(inp):
    """``fused_tcg.prepare`` on ``inp``, with ``CWt`` holding the split
    variant's product for the first iteration: ``(args, const, state, sc,
    cfgsc)``."""
    from xmtpu_torch.ops import fused_tcg as ft
    from xmtpu_torch.ops import manifold as mf

    n, _, o = inp["R"].shape
    args = {k: inp[k] for k in ("R", "s_ex", "CsR", "egR", "egs", "pgR",
                                 "pgs", "gradnorm", "delta", "lam", "cfg",
                                 "minv")}
    const, state, sc, cfgsc = ft.prepare(**args)
    Wf = mf.flatten(ft.from_t(state[4] * const["s_ex_t"]
                                 + const["Rt"] * state[5], n, o))
    const["CWt"].copy_(ft.to_t(mf.unflatten(2.0 * inp["qmul"](Wf))))
    return args, const, state, sc, cfgsc


def time_step(const, state, sc, cfgsc, max_inner: int, reps: int = 200,
              C32=None):
    """Device ms per ``tcg_step`` launch (profiler durations; with ``C32``,
    per ``tcg_step_dense`` launch) on clones of the inputs, the carry reset
    to ``sc`` before every launch so that none returns early."""
    from xmtpu_torch.ops import fused_tcg as ft

    ck = [v.clone() for v in const.values()]
    sk = [t.clone() for t in state]
    sck = sc.clone()
    if C32 is None:
        step = lambda: ft.tcg_step(*ck, *sk, sck, cfgsc, max_inner)  # noqa: E731
    else:
        step = lambda: ft.tcg_step_dense(C32, *ck, *sk, sck, cfgsc,  # noqa: E731
                                         max_inner)
    return device_ms(step, reps, setup=lambda: sck.copy_(sc))


def geometry_text(blocks: int, threads: int) -> str:
    return (f"{blocks} block{'s' * (blocks > 1)} "
            f"({'a cluster' if blocks > 1 else 'no cluster'}) x {threads} "
            f"threads")


def hold_kernels(q64, inp, tag, dense: bool):
    """One iteration and a whole Steihaug loop: kernel vs plain on the card
    (``dense``: ``tcg_step_dense``, the product inside; else ``tcg_step``
    with the split product); ``q64`` is the f64 operator of the reference
    loop.  Returns the max errors, the timings and the launch geometry of
    this case."""
    import torch

    from xmtpu_torch.ops import fused_tcg as ft
    from xmtpu_torch.ops import manifold as mf

    R = inp["R"]
    n, _, o = R.shape
    max_inner = int(inp["cfg"].max_inner)
    args, const, state, sc, cfgsc = step_inputs(inp)
    C32 = ft.dense_matrix(inp["qmul"], n) if dense else None
    out = {"geometry": geometry_text(*(ft.dense_geometry(n, o) if dense
                                       else ft.step_geometry(n, o))),
           "step_geometry": geometry_text(*ft.step_geometry(n, o))}

    # --- one iteration --------------------------------------------------
    def clone_all():
        c = {k: v.clone() for k, v in const.items()}
        return c, tuple(t.clone() for t in state), sc.clone()

    def launch(c, st, s_):
        if dense:
            ft.tcg_step_dense(C32, *c.values(), *st, s_, cfgsc, max_inner)
        else:
            ft.tcg_step(*c.values(), *st, s_, cfgsc, max_inner)

    ck, sk, sck = clone_all()
    cp, sp, scp = clone_all()
    cr, sr, scr = clone_all()
    launch(ck, sk, sck)
    launch(cr, sr, scr)
    if dense:
        ft.tcg_step_dense_plain(C32, *cp.values(), *sp, scp, cfgsc, max_inner)
    else:
        ft.tcg_step_plain(*cp.values(), *sp, scp, cfgsc, max_inner)
    torch.cuda.synchronize()
    name = "tcg_step_dense" if dense else "tcg_step"
    if not all(torch.equal(a, b) for a, b in zip((ck["CWt"], *sk, sck),
                                                 (cr["CWt"], *sr, scr))):
        raise AssertionError(f"{tag} {name}: two launches on the same "
                             f"inputs differ")
    if dense:
        scale = max(1e-3, float(cp["CWt"].abs().max()))
        out["cw_err"] = assert_close(f"{tag} {name} CW", ck["CWt"],
                                     cp["CWt"], 5e-4 * scale, 5e-3)
    sc_k, sc_p = sck.tolist(), scp.tolist()
    if [sc_k[i] for i in (ft.S_ER, ft.S_DONE, ft.S_I)] != \
            [sc_p[i] for i in (ft.S_ER, ft.S_DONE, ft.S_I)]:
        raise AssertionError(f"{tag} {name} carry: kernel {sc_k} vs "
                             f"plain {sc_p}")
    # the step v (and its scale part) at the v tolerance, everything derived
    # from the Hessian product at the Hv tolerance
    errs = [assert_close(f"{tag} {name} carry", sck[:ft.S_ER],
                         scp[:ft.S_ER], 0.0, 5e-3)]
    names = ("vR", "vs", "rR", "rs", "pR", "ps", "hvR", "hvs")
    for nm, a, b in zip(names, sk, sp):
        at, rt = (2e-4, 2e-3) if nm in ("vR", "vs") else (5e-4, 5e-3)
        scale = max(1e-3, float(b.abs().max()))
        errs.append(assert_close(f"{tag} {name} {nm}", a, b, at * scale, rt))
    out["step_err"] = worst(errs)

    # --- the whole Steihaug loop -----------------------------------------
    res_k = ft.inner_tcg_fused(inp["qmul"], **args)

    def plain_loop(gen=None):
        """The loop through the plain versions; with ``gen``, every product
        is perturbed by a fresh relative f32 rounding (another summation
        order's worth of noise)."""
        cp, sp, scp = {k: v.clone() for k, v in const.items()}, \
            tuple(t.clone() for t in state), sc.clone()
        for _ in range(max_inner):
            if dense:
                ft.tcg_cw_dense_plain(C32, cp["Rt"], cp["s_ex_t"], sp[4],
                                      sp[5], scp, cp["CWt"], max_inner)
            else:
                Wf = mf.flatten(ft.from_t(sp[4] * cp["s_ex_t"]
                                             + cp["Rt"] * sp[5], n, o))
                cp["CWt"].copy_(ft.to_t(mf.unflatten(2.0 * inp["qmul"](Wf))))
            if gen is not None:
                u = torch.rand(cp["CWt"].shape, generator=gen) * 2.0 - 1.0
                cp["CWt"].mul_(1.0 + 2.0 ** -24 * u.to(cp["CWt"].device))
            ft.tcg_step_plain(*cp.values(), *sp, scp, cfgsc, max_inner)
            if ft._stopped(scp, max_inner):
                break
        car = scp.tolist()
        return (ft.from_t(sp[0], n, o), ft.unpack_s(sp[1], n),
                ft.from_t(sp[6], n, o), ft.unpack_s(sp[7], n),
                int(car[ft.S_ER]), int(car[ft.S_I]))

    res_p = plain_loop()
    # How far f32 rounding alone moves this loop: the plain loop against the
    # same loop in f64.  Where that is within the f32 tolerance (a
    # well-separated problem) the kernel must match the plain version to the
    # tolerance, end reason and iteration count included.  Where it is not
    # (near a saddle, every f32 summation order ends elsewhere), the kernel
    # must be no further from the f64 loop than twice the f32 noise band:
    # the largest gap of the plain version, as it runs and under three
    # seeded f32-rounding perturbations of its products (one sample of that
    # band ranged over 1.4e-2-5.4e-2 at scene A's escape point across runs).
    res_64 = f64_loop(q64, inp)
    d64 = rel_gap(res_p, res_64)
    out["loop"], out["loop_f64_gap"] = (res_k[4], res_k[5]), d64
    if d64 <= 2e-3 and res_p[4:] == res_64[4:]:
        if res_k[4:] != res_p[4:]:
            raise AssertionError(f"{tag} Steihaug loop: kernel endreason/"
                                 f"iters {res_k[4:]} vs plain {res_p[4:]}")
        scale = max(1e-3, float(res_p[0].abs().max()))
        hscale = max(1e-3, float(res_p[2].abs().max()))
        out["loop_err"] = worst([
            assert_close(f"{tag} loop vR", res_k[0], res_p[0], 2e-4 * scale,
                         2e-3),
            assert_close(f"{tag} loop vs", res_k[1], res_p[1], 2e-4, 2e-3),
            assert_close(f"{tag} loop hvR", res_k[2], res_p[2],
                         5e-4 * hscale, 5e-3),
            assert_close(f"{tag} loop hvs", res_k[3], res_p[3], 5e-4, 5e-3)])
    else:
        band = [d64] + [rel_gap(plain_loop(torch.Generator().manual_seed(k)),
                                res_64) for k in range(3)]
        out["loop_f64_gap"] = max(band)
        dk = rel_gap(res_k, res_64)
        if not dk <= 2.0 * max(band) + 2e-3:
            raise AssertionError(f"{tag} Steihaug loop: kernel {dk:.3e} from "
                                 f"the f64 loop, plain "
                                 f"{', '.join(f'{b:.3e}' for b in band)}")
        out["loop_err"] = (max(float((a - b).abs().max())
                               for a, b in zip(res_k[:4], res_p[:4])),
                           rel_gap(res_k, res_p))

    # --- timings -----------------------------------------------------------
    reps = 200
    out["step_ms"] = time_step(const, state, sc, cfgsc, max_inner, reps)
    out["step_bound"] = bound_ms(*step_bytes_ops(n, o))
    ck, sk, sck = clone_all()
    reset = lambda: sck.copy_(sc)  # noqa: E731 — a live carry every launch
    if dense:
        out["dense_ms"] = time_step(const, state, sc, cfgsc, max_inner, reps,
                                    C32=C32)
        out["dense_enqueue_ms"] = cuda_ms(lambda: launch(ck, sk, sck), reps,
                                          setup=reset)
        ck, sk, sck = clone_all()
        out["dense_plain_ms"] = cuda_ms(lambda: ft.tcg_step_dense_plain(
            C32, *ck.values(), *sk, sck, cfgsc, max_inner), 20, setup=reset)
        out["dense_bound"] = bound_ms(*dense_bytes_ops(n, o))
        # the library yardstick: the product alone, on this call's W
        Wf = mf.flatten(ft.from_t(sk[4] * ck["s_ex_t"] + ck["Rt"] * sk[5],
                                  n, o)).contiguous()
        out["cw_library_ms"] = device_ms(lambda: torch.matmul(C32, Wf),
                                         reps)
    else:
        out["step_enqueue_ms"] = cuda_ms(lambda: launch(ck, sk, sck), reps,
                                         setup=reset)
        ck, sk, sck = clone_all()
        out["step_plain_ms"] = cuda_ms(lambda: ft.tcg_step_plain(
            *ck.values(), *sk, sck, cfgsc, max_inner), 20, setup=reset)
    return out


def hold_case(tag, q64, inp, dense: bool) -> dict:
    """:func:`hold_kernels` on one case, logged."""
    r = hold_kernels(q64, inp, tag, dense)
    msg = (f"[smoke] {tag}: {r['geometry']}; step err {r['step_err'][1]:.1e} "
           f"(two launches: same bits) loop (endreason, iters)={r['loop']} "
           f"err {r['loop_err'][1]:.1e} (f32 noise band vs f64 loop "
           f"{r['loop_f64_gap']:.1e}); ")
    if dense:
        msg += (f"tcg_step_dense CW err {r['cw_err'][1]:.1e}, "
                f"{r['dense_ms']:.4f} ms (enqueue {r['dense_enqueue_ms']:.4f})"
                f" plain {r['dense_plain_ms']:.4f} ms bound "
                f"{r['dense_bound'][0]:.5f}; yardsticks: matmul "
                f"{r['cw_library_ms']:.4f} ms, tcg_step alone "
                f"{r['step_ms']:.4f} ms ({r['step_geometry']}, bound "
                f"{r['step_bound'][0]:.5f})")
    else:
        msg += (f"tcg_step {r['step_ms']:.4f} ms (enqueue "
                f"{r['step_enqueue_ms']:.4f}) plain {r['step_plain_ms']:.4f} "
                f"ms bound {r['step_bound'][0]:.5f}")
    log(msg)
    return r


def segsum_bytes_ops(rows: int, S: int, D: int, item: int, idx_words: int):
    """Bytes a segment sum must move (values and ``idx_words`` int32 index
    words read once, the (S, D) output written once) and its adds."""
    return rows * D * item + idx_words * 4 + S * D * item, rows * D


def hold_segsum(Q, dev, reps: int = 100):
    """Both segment-sum kernels against their plain twin on the card, on the
    operator's real orderings.  Returns one dict per case."""
    import torch

    from xmtpu_torch.ops import segsum as ss

    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)
    E = int(Q.l_l.shape[0])
    sched = ss.schedule_edges(Q.l_l.cpu().numpy().astype(np.int32),
                              Q.n_landmarks)
    ids_s, gidx, pad, blk, first, band = sched
    ids_s = torch.as_tensor(ids_s, device=dev)
    gidx = torch.as_tensor(gidx, device=dev)
    live = torch.as_tensor(~pad, device=dev)
    G = len(blk)
    cases = []
    for order, ids, off, S in (("l", Q.l_l, Q.bounds_l, Q.n_landmarks),
                               ("f", Q.f_f, Q.bounds_f, Q.n_cameras)):
        longest = int((off[1:] - off[:-1]).max())
        for dt in (torch.float32, torch.float64):
            eps = float(torch.finfo(dt).eps)
            item = torch.finfo(dt).bits // 8
            peak = PEAK_F32 if dt == torch.float32 else PEAK_F64
            for D in (3, 6, 9, 18):
                vals = torch.randn((E, D), generator=gen,
                                   dtype=torch.float64).to(dt).to(dev)
                # both versions sum each segment in some order: each lies
                # within (L-1) eps sum|x| of the exact sum, L the longest
                # segment
                absum = ss.sorted_segment_sum_plain(vals.abs(), ids, S)
                tol = 2.0 * longest * eps * absum
                scale = float(absum.max())
                runs = [("csr", lambda: ss.sorted_segment_sum(
                            vals, ids, S, offsets=off),
                         ss.sorted_segment_sum_plain(vals, ids, S),
                         segsum_bytes_ops(E, S, D, item, S + 1))]
                if order == "l":
                    vs = (vals[gidx] * live[:, None]).contiguous()
                    runs.append(("blocked", lambda: ss.sorted_segment_sum_blocked(
                        vs, ids_s, S, blk, first, band),
                        ss.sorted_segment_sum_plain(vs, ids_s, S),
                        segsum_bytes_ops(G * ss.CHUNK, S, D, item,
                                         G * ss.CHUNK + G)))
                for kind, call, want, (nbytes, ops) in runs:
                    a, b = call(), call()
                    torch.cuda.synchronize()
                    tag = f"{kind} {order} {str(dt)[6:]} D={D}"
                    if not torch.equal(a, b):
                        raise AssertionError(f"segsum {tag}: two launches "
                                             f"differ")
                    # the CSR kernel adds in row order from zero, as the
                    # CPU twin does: the same bits
                    if kind == "csr" and not torch.equal(
                            a.cpu(), ss.sorted_segment_sum_plain(
                                vals.cpu(), ids.cpu(), S)):
                        raise AssertionError(f"segsum {tag}: not the CPU "
                                             f"twin's bits")
                    err = (a - want).abs()
                    if bool((err > tol).any()) or not bool(
                            torch.isfinite(a).all()):
                        raise AssertionError(
                            f"segsum {tag}: {int((err > tol).sum())} entries "
                            f"beyond 2 L eps sum|x| (max err "
                            f"{float(err.max()):.3e})")
                    src = vals if kind == "csr" else vs
                    sid = ids if kind == "csr" else ids_s
                    out = torch.zeros_like(want)
                    cases.append(dict(
                        kernel=kind, tag=tag, order=order, D=D,
                        dtype=str(dt)[6:], max_abs_err=float(err.max()),
                        max_rel_err=float(err.max()) / max(scale, 1e-30),
                        ms=device_ms(call, reps),
                        plain_ms=cuda_ms(lambda: ss.sorted_segment_sum_plain(
                            src, sid, S), reps),
                        library_ms=device_ms(
                            lambda: out.index_add_(0, sid, src), reps),
                        bound=bound_ms(nbytes, ops, peak)))
    return cases


def rotation_error_stats(R_real, R_gt, indices_all=None):
    """Max and mean angular error (radians) of recovered c2w rotation blocks
    ``R_real (3, 3N)`` against the scene's ``R_gt``, gauge-fixed to camera
    0; ``indices_all`` maps original frames to the cleaned ones."""
    from xmtpu_torch.pipeline.synthetic import rotation_errors

    N = R_real.shape[1] // 3
    B = R_real.reshape(3, N, 3).transpose(1, 0, 2)
    gt = R_gt
    if indices_all is not None:
        gt = np.zeros((N, 3, 3))
        live = indices_all > -1
        gt[indices_all[live]] = R_gt[live]
    e = rotation_errors(B, gt, gauge="left")
    return dict(max=float(e.max()), mean=float(e.mean()))


def check_rotations(tag, got, ref):
    for k in ("max", "mean"):
        if not got[k] <= ROT_SLACK * ref[k]:
            raise AssertionError(f"{tag}: rotation error {k} {got[k]:.3e} "
                                 f"beyond {ROT_SLACK} x the reference's "
                                 f"{ref[k]:.3e}")


def counted_kernels():
    from xmtpu_torch.ops import fused_tcg as ft
    from xmtpu_torch.ops import segsum as ss

    return (ft.tcg_step, ft.tcg_step_dense, ss.sorted_segment_sum,
            ss.sorted_segment_sum_blocked)


def reset_counts():
    from xmtpu_torch.ops import segsum as ss

    for k in counted_kernels():
        k.launches = 0
    ss.sorted_segment_sum.shapes = {}


def read_counts() -> dict:
    """Launches by kernel, and the segment sum's by dtype and D."""
    from xmtpu_torch.ops import segsum as ss

    out = {k.__name__: k.launches for k in counted_kernels()}
    out["sorted_segment_sum shapes"] = dict(ss.sorted_segment_sum.shapes)
    return out


def hold_carried_operator(scB, dev) -> dict:
    """Scene B's ``SchurQ`` built on the host, moved to the card by
    ``as_qop``: each variant's apply must launch the segment-sum kernel, give
    the same bits twice, and lie no further from the exact host apply than
    twice the same variant's host apply does (1e-9 for the exact operator;
    the f32 variants sit at their f32-accumulation floor, ~6e-6 here).
    Returns ``(card, host)`` relative distances from the exact apply by
    variant."""
    import torch

    from xmtpu_torch.ops import segsum as ss
    from xmtpu_torch.ops.qop import as_qop, cast_qop
    from xmtpu_torch.ops.schurq import SchurQ

    q_host = SchurQ.build(scB.weights, scB.edges, scB.landmarks, device="cpu")
    q_card = as_qop(q_host, device=dev)
    gen = torch.Generator().manual_seed(0)
    Y = torch.randn((q_host.dim, 3), generator=gen, dtype=torch.float64)
    exact = q_host.apply(Y)

    def rel(a):
        return float(torch.linalg.norm(a.cpu().double() - exact)
                     / torch.linalg.norm(exact))

    out = {}
    for tag, make in (("SchurQ", lambda q: q),
                      ("f32 cast", lambda q: cast_qop(q, torch.float32)),
                      ("two_float", lambda q: q.two_float())):
        qh, qc = make(q_host), make(q_card)
        y = Y.to(qh.Q1.dtype)
        n0 = ss.sorted_segment_sum.launches
        a, b = qc.apply(y.to(dev)), qc.apply(y.to(dev))
        torch.cuda.synchronize()
        if ss.sorted_segment_sum.launches < n0 + 8 or not torch.equal(a, b):
            raise AssertionError(f"carried {tag}: launches "
                                 f"{ss.sorted_segment_sum.launches - n0}, "
                                 f"repeatable {torch.equal(a, b)}")
        d_card, d_host = rel(a), rel(qh.apply(y))
        if not d_card <= 2.0 * d_host + 1e-9:
            raise AssertionError(f"carried {tag}: {d_card:.2e} from the "
                                 f"exact apply, host {d_host:.2e}")
        out[tag] = (d_card, d_host)
    return out


def scene(params, device):
    from xmtpu_torch.assembly.creatematrix import create_matrix_arrays
    from xmtpu_torch.pipeline.synthetic import make_scene
    import torch

    t0 = time.perf_counter()
    sc = make_scene(**params)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    C, _ = create_matrix_arrays(sc.weights, sc.edges, sc.landmarks,
                                device=device)
    torch.cuda.synchronize()
    t_asm = time.perf_counter() - t0
    return C, t_gen, t_asm


class SceneD(NamedTuple):
    R: np.ndarray            # (N, 3, 3) world-to-camera rotations
    t: np.ndarray            # (N, 3) world-to-camera translations
    pts: np.ndarray          # (M, 3) room points
    K: np.ndarray            # (3, 3)
    keypoints: list          # N arrays (k_i, 2), f32-representable pixels
    point_of_kp: list        # N arrays (k_i,) point id of each keypoint
    pairs: np.ndarray        # (P, 2) frame pairs i < j, sorted
    matches: list            # P arrays (K_p, 2) keypoint indices
    E: np.ndarray            # (P, 3, 3) stored essential matrices
    corrupted: np.ndarray    # (P,) bool: E from a corrupted rotation


def _rotvec(w):
    """Rodrigues of one rotation vector (numpy)."""
    th = float(np.linalg.norm(w))
    if th == 0.0:
        return np.eye(3)
    k = w / th
    Kx = np.array([[0.0, -k[2], k[1]], [k[2], 0.0, -k[0]],
                   [-k[1], k[0], 0.0]])
    return np.eye(3) + np.sin(th) * Kx + (1.0 - np.cos(th)) * Kx @ Kx


def make_scene_d(n_frames: int = 200, n_points: int = 8000,
                 seed: int = 0) -> SceneD:
    """Scene D (numpy only, seeded): ``n_frames`` on a closed elliptic loop
    heading along it with a yaw sway, ``n_points`` spread over the walls,
    floor and ceiling of the room by area, the Replica camera, keypoints
    with ``SCENE_D_PIXEL_NOISE`` px of noise, and for every pair sharing at
    least ``SCENE_D_MIN_SHARED`` points a ``CALIBRATED`` two-view geometry
    whose E comes from the GT relative pose, or for a seeded
    ``SCENE_D_BAD`` share of them from that rotation turned by 20-40
    degrees."""
    from xmtpu_torch.pipeline.viewgraph import essential_from_motion

    rng = np.random.default_rng(seed)
    lp, cam = SCENE_D_LOOP, SCENE_D_CAMERA
    W, H = cam["width"], cam["height"]
    K = np.array([[cam["f"], 0.0, cam["cx"]], [0.0, cam["f"], cam["cy"]],
                  [0.0, 0.0, 1.0]])

    a = 2.0 * np.pi * np.arange(n_frames) / n_frames
    centers = np.stack([lp["rx"] * np.cos(a), lp["ry"] * np.sin(a),
                        np.full(n_frames, lp["height"])], axis=1)
    yaw = (np.arctan2(lp["ry"] * np.cos(a), -lp["rx"] * np.sin(a))
           + lp["sway"] * np.sin(lp["sway_cycles"] * a))
    fwd = np.stack([np.cos(yaw), np.sin(yaw), np.zeros(n_frames)], axis=1)
    down = np.broadcast_to([0.0, 0.0, -1.0], fwd.shape)
    R = np.stack([np.cross(down, fwd), down, fwd], axis=1)
    t = -np.einsum("nab,nb->na", R, centers)

    # room surfaces, picked by area: floor, ceiling, walls x = +-X/2,
    # walls y = +-Y/2
    X, Y, Z = SCENE_D_ROOM
    areas = np.array([X * Y, X * Y, Y * Z, Y * Z, X * Z, X * Z])
    face = rng.choice(6, size=n_points, p=areas / areas.sum())
    u = rng.random((n_points, 2))
    lo, ext = np.array([-X / 2, -Y / 2, 0.0]), np.array([X, Y, Z])
    pts = np.zeros((n_points, 3))
    for k, (fixed, val, free) in enumerate(
            [(2, 0.0, (0, 1)), (2, Z, (0, 1)), (0, -X / 2, (1, 2)),
             (0, X / 2, (1, 2)), (1, -Y / 2, (0, 2)), (1, Y / 2, (0, 2))]):
        sel = face == k
        pts[sel, fixed] = val
        for c, f in enumerate(free):
            pts[sel, f] = lo[f] + ext[f] * u[sel, c]

    keypoints, point_of_kp = [], []
    kp_of_point = np.full((n_frames, n_points), -1, dtype=np.int64)
    for i in range(n_frames):
        pc = pts @ R[i].T + t[i]
        front = pc[:, 2] > 0.1
        uv = (pc[:, :2] / np.where(front, pc[:, 2], 1.0)[:, None]
              * cam["f"] + [cam["cx"], cam["cy"]])
        uv = uv + rng.normal(scale=SCENE_D_PIXEL_NOISE, size=uv.shape)
        # the database keeps f32 keypoints: hold them so from the start
        uv = uv.astype(np.float32).astype(np.float64)
        ok = (front & (uv[:, 0] >= 0) & (uv[:, 0] < W) & (uv[:, 1] >= 0)
              & (uv[:, 1] < H))
        ids = np.flatnonzero(ok)
        keypoints.append(uv[ids])
        point_of_kp.append(ids)
        kp_of_point[i, ids] = np.arange(len(ids))

    vis = (kp_of_point >= 0).astype(np.float32)
    shared = vis @ vis.T
    ii, jj = np.triu_indices(n_frames, k=1)
    keep = shared[ii, jj] >= SCENE_D_MIN_SHARED
    pairs = np.stack([ii[keep], jj[keep]], axis=1)
    P = len(pairs)
    bad = np.zeros(P, dtype=bool)
    bad[rng.choice(P, size=int(round(SCENE_D_BAD["share"] * P)),
                   replace=False)] = True
    lo_deg, hi_deg = SCENE_D_BAD["deg"]
    matches, E = [], np.zeros((P, 3, 3))
    for p, (i, j) in enumerate(pairs):
        common = np.flatnonzero((kp_of_point[i] >= 0) & (kp_of_point[j] >= 0))
        matches.append(np.stack([kp_of_point[i, common],
                                 kp_of_point[j, common]], axis=1))
        Rij = R[j] @ R[i].T                          # cam2_from_cam1
        tij = t[j] - Rij @ t[i]
        if bad[p]:
            axis = rng.normal(size=3)
            axis /= np.linalg.norm(axis)
            Rij = _rotvec(axis * np.radians(rng.uniform(lo_deg, hi_deg))) @ Rij
        E[p] = essential_from_motion(Rij, tij / np.linalg.norm(tij))
    return SceneD(R, t, pts, K, keypoints, point_of_kp, pairs, matches, E,
                  bad)


def write_scene_d(path: str, sc: SceneD) -> None:
    """The scene as a COLMAP ``database.db`` (the port's writer): one
    camera with its prior focal, frames named ``frame%04d.png``."""
    from xmtpu_torch.pipeline import colmap_db as cdb
    from xmtpu_torch.pipeline.undistort import Camera

    cam = SCENE_D_CAMERA
    cameras = {1: Camera(model="SIMPLE_PINHOLE",
                         params=[cam["f"], cam["cx"], cam["cy"]],
                         width=cam["width"], height=cam["height"])}
    N = len(sc.R)
    images = {i + 1: (f"frame{i:04d}.png", 1) for i in range(N)}
    kps = {i + 1: sc.keypoints[i] for i in range(N)}
    tvgs = {(int(i) + 1, int(j) + 1): {"matches": m, "config": cdb.CALIBRATED,
                                       "E": E}
            for (i, j), m, E in zip(sc.pairs, sc.matches, sc.E)}
    cdb.write_database(path, cameras, images, keypoints=kps,
                       two_view_geometries=tvgs, prior_focal={1: True})


def scene_d_depth(sc: SceneD, i: int):
    """GT depth map of frame ``i``: the true z of each keypoint's point at
    its truncated pixel, zeros elsewhere; unit confidence."""
    cam = SCENE_D_CAMERA
    d = np.zeros((cam["height"], cam["width"]))
    uv = sc.keypoints[i].astype(int)
    d[uv[:, 1], uv[:, 0]] = (sc.pts[sc.point_of_kp[i]] @ sc.R[i][2]
                             + sc.t[i][2])
    return d, np.ones_like(d)


def scene_d_calibration_inputs(sc: SceneD, seed: int = 0):
    """Inputs of ``calibrate_view_graph`` at scene D's pair count: F of
    general-position relative poses (a random axis turned by 0.2-0.6 rad, a
    random translation direction; as ``tests/test_colmap_db.py`` builds
    them) under scene D's camera, one camera starting at 0.85 f.  The
    loop's own relative poses turn about the vertical only, so every two
    optical axes meet and the focal is not observable from them (the JAX
    package lands at 634.1 instead of 600 on the 24-frame scene).  Returns
    ``(F, cam0, cam1, principal_points, focals0)``."""
    from xmtpu_torch.pipeline.calibration import fundamental_from_pose

    rng = np.random.default_rng(seed)
    P = len(sc.pairs)
    F = np.zeros((P, 3, 3))
    for p in range(P):
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        Rij = _rotvec(axis * (0.2 + 0.4 * rng.random()))
        tij = rng.normal(size=3)
        F[p] = fundamental_from_pose(sc.K, sc.K, Rij, tij / np.linalg.norm(tij))
    zero = np.zeros(P, dtype=np.int64)
    return (F, zero, zero, sc.K[None, :2, 2].copy(),
            np.array([0.85 * SCENE_D_CAMERA["f"]]))


def scene_d_stored_relposes(sc: SceneD):
    """The relative rotation of every stored pair, decomposed from its E on
    its matches' bearings as the mapper's stage 0 does, before stage 2's
    inlier test: the corrupted pairs carry their corrupted rotations."""
    from xmtpu_torch.pipeline.manipulation import pose_from_essential
    from xmtpu_torch.pipeline.undistort import Camera, undistorted_bearings

    c = SCENE_D_CAMERA
    cam = Camera(model="SIMPLE_PINHOLE", params=[c["f"], c["cx"], c["cy"]],
                 width=c["width"], height=c["height"])
    R_rel = np.empty((len(sc.pairs), 3, 3))
    for p, (i, j) in enumerate(sc.pairs):
        m = sc.matches[p]
        R_rel[p] = pose_from_essential(
            sc.E[p], undistorted_bearings(cam, sc.keypoints[i][m[:, 0]]),
            undistorted_bearings(cam, sc.keypoints[j][m[:, 1]]))[0]
    return R_rel


def filter_iterations(fn):
    """Runs ``fn`` (a ``filter_pairs`` call) counting the iterations of its
    loops: the L1 phase's (calls of the ADMM solve), the ADMM's over all of
    them (its z-update soft-thresholds each leaf of ``b`` once an
    iteration) and the IRLS phase's (rotation updates past the L1 phase's).
    Returns ``(fn(), counts)``."""
    from xmtpu_torch.ops import l1
    from xmtpu_torch.pipeline import rotation_averaging as ra

    n = dict(l1=0, admm=0, irls=0, shrink=0, updates=0)
    make, shrink, expm = ra.make_l1_admm, l1._shrinkage, ra._expm_so3

    def counting_make(*a, **k):
        solve = make(*a, **k)

        def counted(b, x0, max_iters):
            n["l1"] += 1
            before = n["shrink"]
            x = solve(b, x0, max_iters)
            n["admm"] += (n["shrink"] - before) // len(b)
            return x
        return counted

    def counting_shrink(*a):
        n["shrink"] += 1
        return shrink(*a)

    def counting_expm(*a):
        n["updates"] += 1
        return expm(*a)

    ra.make_l1_admm, l1._shrinkage, ra._expm_so3 = (
        counting_make, counting_shrink, counting_expm)
    try:
        out = fn()
    finally:
        ra.make_l1_admm, l1._shrinkage, ra._expm_so3 = make, shrink, expm
    n["irls"] = n.pop("updates") - n["l1"]
    del n["shrink"]
    return out, n


def scene_d_report(out, sc: SceneD):
    """``metrics.evaluate`` of an ``XM2Result`` against scene D's GT (w2c
    convention, solved frames mapped through ``indices_all``), as the
    reference's example 03 reports it."""
    from xmtpu_torch.pipeline import metrics

    R_gt = sc.R.transpose(0, 2, 1)                   # c2w
    centers = -np.einsum("nba,nb->na", sc.R, sc.t)
    live = out.indices_all > -1
    order = out.indices_all[live]
    R_gt_w2c = np.concatenate([R.T for R in R_gt[live]], axis=1)
    t_w2c = -np.einsum("nba,nb->na", R_gt[live], centers[live]).T
    N2 = out.s_real.shape[0]
    Rb = out.R_real.reshape(3, N2, 3).transpose(1, 0, 2)[order]
    return metrics.evaluate(Rb.transpose(1, 0, 2).reshape(3, -1),
                            out.t_est[:, order], R_gt_w2c, t_w2c)


def device_work(fn, tries: int = 5):
    """Runs ``fn`` once under ``torch.profiler``: the kernels it launched
    on the card, its device-to-host copies, and its scalar reads
    (``_local_scalar_dense``: ``bool``/``float`` of a card tensor).  A
    traced run with no kernel or no copy recorded (the profiler now and
    then drops a run's events) is taken again."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ev = prof.events()
        dev_ev = [e.name for e in ev if e.device_type == DeviceType.CUDA]
        kernels = sum(not n.startswith(("Memcpy", "Memset")) for n in dev_ev)
        d2h = sum("DtoH" in n for n in dev_ev)
        reads = sum(e.name == "aten::_local_scalar_dense" for e in ev
                    if e.device_type == DeviceType.CPU)
        if kernels and d2h:
            return dict(launches=kernels, d2h_copies=d2h, scalar_reads=reads)
    raise RuntimeError("device_work: the profiler recorded no kernel or no "
                       f"copy, {tries} times")


def run_xm2_d(xm2, lifted, N, M, dev, **kw):
    """``xm2_solve`` on scene D's lifted data; returns the result, the last
    staircase solve (the certified one), the ranks of every solve, the
    phase timer and the wall."""
    import torch

    from xmtpu_torch.utils.timer import PhaseTimer

    edges, weights, landmarks = lifted
    solves, orig = [], xm2.solve_arrays

    def recording(*a, **k):
        solves.append(orig(*a, **k))
        return solves[-1]

    timer = PhaseTimer()
    xm2.solve_arrays = recording
    t0 = time.perf_counter()
    try:
        out = xm2.xm2_solve(edges.copy(), weights.copy(), landmarks.copy(),
                            np.zeros((len(landmarks), 3)), N, M,
                            verbose=False, timer=timer, device=dev, **kw)
        torch.cuda.synchronize()
    finally:
        xm2.solve_arrays = orig
    return (out, solves[-1], [r.rank for r in solves], timer,
            time.perf_counter() - t0)


def hold_default_tol(xm2, out, last, dev):
    """Holds scene D's implicit run at the default tol, whose f32 and
    two-float stages let noise pick pass 2's lam (see ``XM2_D_ARGS``): its
    last solve must certify at the rank that the dense f64 route certifies
    on the same observations at the lam the run picked, with the primal
    within ``RTOL_IMPLICIT`` of that route's."""
    import torch

    t0 = time.perf_counter()
    op, _, _ = xm2._assemble_operator(out.weights, out.edges, out.landmarks,
                                      False, False, "f64", dev)
    wit = xm2.solve_arrays(op, 5, 1e-1, out.lam, 1000.0, verbose=False,
                           precision="f64", device=dev)
    torch.cuda.synchronize()
    log(f"[smoke] scene D default tol, the dense route on its "
        f"{len(out.edges)} observations at lam {out.lam}: certified "
        f"{wit.certified} at rank {wit.rank}, primal {wit.primal!r} "
        f"({time.perf_counter() - t0:.2f} s); the JAX package: lam "
        f"{XM2_D_DEFAULT['lam']}, rank {XM2_D_DEFAULT['rank']}, primal "
        f"{XM2_D_DEFAULT['primal']!r}; with lam forced to "
        f"{XM2_D_FORCED['lam']}: rank {XM2_D_FORCED['rank']}, primal "
        f"{XM2_D_FORCED['primal']!r}")
    if not (wit.certified and last.certified and last.rank == wit.rank):
        raise AssertionError(f"scene D default tol: certified "
                             f"{last.certified} at rank {last.rank}, the "
                             f"dense route at its lam {wit.certified} at "
                             f"rank {wit.rank}")
    if abs(last.primal - wit.primal) > RTOL_IMPLICIT * wit.primal:
        raise AssertionError(f"scene D default tol: primal {last.primal} vs "
                             f"the dense route's {wit.primal}")


def run_scene_d(dev, counts):
    """Phase 9: scene D written as a COLMAP database, ``python -m
    xmtpu_torch mapper`` twice (equal tempdata), held against the JAX
    package's counts; ``filter_pairs``' launches and host reads; lifting
    with GT depth; ``xm2_solve`` dense and implicit, held against the JAX
    package's runs; ``calibrate_view_graph`` on the card."""
    import filecmp
    import tempfile

    import torch

    from xmtpu_torch.__main__ import main as cli
    from xmtpu_torch.pipeline import global_mapper as gm
    from xmtpu_torch.pipeline import xm2
    from xmtpu_torch.pipeline.calibration import calibrate_view_graph
    from xmtpu_torch.pipeline.frontend import (build_view_graph, lift_dataset,
                                               parse_glomap_tempdata)
    from xmtpu_torch.pipeline.rotation_averaging import filter_pairs

    t0 = time.perf_counter()
    scD = make_scene_d(**SCENE_D)
    t_gen = time.perf_counter() - t0
    n_obs = [len(k) for k in scD.keypoints]
    log(f"[smoke] scene D: {len(scD.R)} frames, {len(scD.pts)} points, "
        f"{np.mean(n_obs):.1f} keypoints a frame ({sum(n_obs)} in all), "
        f"{len(scD.pairs)} pairs sharing >= {SCENE_D_MIN_SHARED} points, "
        f"{sum(len(m) for m in scD.matches)} matches, "
        f"{int(scD.corrupted.sum())} corrupted; generated in {t_gen:.2f} s")
    with tempfile.TemporaryDirectory() as tmp:
        db = os.path.join(tmp, "database.db")
        t0 = time.perf_counter()
        write_scene_d(db, scD)
        log(f"[smoke] scene D database: {time.perf_counter() - t0:.2f} s, "
            f"{os.path.getsize(db) / 2**20:.1f} MiB")

        # the mapper twice through the command line; the first run's first
        # filter_pairs call is kept to count its launches and host reads
        first, orig = [], gm.filter_pairs

        def recording(*a, **k):
            if not first:
                first.append((a, k))
            return orig(*a, **k)

        outs, walls = [], []
        gm.filter_pairs = recording
        try:
            for k in range(2):
                outs.append(os.path.join(tmp, f"tempdata{k}"))
                t0 = time.perf_counter()
                rc = cli(["mapper", "--database_path", db, "--output_path",
                          outs[-1]], device=dev)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                if rc != 0:
                    raise AssertionError(f"scene D mapper: exit code {rc}")
        finally:
            gm.filter_pairs = orig
        log(f"[smoke] scene D mapper walls: {walls[0]:.2f} s, "
            f"{walls[1]:.2f} s")
        for name in ("output.txt", "filename.txt", "relative_pose.txt"):
            if not filecmp.cmp(os.path.join(outs[0], name),
                               os.path.join(outs[1], name), shallow=False):
                raise AssertionError(f"scene D: the two mapper runs wrote "
                                     f"different {name}")
        (a, k), = first
        work = device_work(lambda: orig(*a, **k))
        log(f"[smoke] scene D filter_pairs ({len(a[0])} pairs, one call): "
            f"{work['launches']} kernel launches, {work['scalar_reads']} "
            f"scalar reads, {work['d2h_copies']} device-to-host copies")
        exp = parse_glomap_tempdata(outs[0])

    # the mapper's counts, exact, and its pair filter
    got = dict(registered=len(np.unique(exp.matches[:, 0])),
               valid_pairs=len(exp.relposes), n_tracks=exp.M,
               n_obs=len(exp.matches))
    log(f"[smoke] scene D mapper: {got} (JAX package: {MAPPER_D})")
    if got != MAPPER_D:
        raise AssertionError(f"scene D mapper counts {got} vs {MAPPER_D}")
    pair_of = {(int(i) + 1, int(j) + 1): p
               for p, (i, j) in enumerate(scD.pairs)}
    kept = np.zeros(len(scD.pairs), dtype=bool)
    r_err = 0.0
    for (id1, id2), (R, _) in exp.relposes.items():
        kept[pair_of[(id1, id2)]] = True
        R_gt = scD.R[id2 - 1] @ scD.R[id1 - 1].T
        r_err = max(r_err, float(np.abs(R - R_gt).max()))
    log(f"[smoke] scene D pairs: {int((kept & scD.corrupted).sum())} of "
        f"{int(scD.corrupted.sum())} corrupted kept, "
        f"{int((~kept & ~scD.corrupted).sum())} clean dropped; R_rel "
        f"{r_err:.2e} from GT at most")
    if (kept & scD.corrupted).any() or (~kept & ~scD.corrupted).any():
        raise AssertionError("scene D: a corrupted pair kept or a clean pair "
                             "dropped")
    if not r_err <= 1e-4:
        raise AssertionError(f"scene D: R_rel {r_err:.2e} from GT")

    # the robust path: filter_pairs on every stored pair with the rotation
    # decomposed from its E, the corrupted ones included (in the mapper
    # stage 2's inlier test drops them before stage 3 sees them)
    t0 = time.perf_counter()
    R_st = scene_d_stored_relposes(scD)
    t_dec = time.perf_counter() - t0
    w_st = np.array([len(m) for m in scD.matches], dtype=np.float64)

    def robust():
        return filter_pairs(scD.pairs, R_st, len(scD.R), max_angle_deg=10.0,
                            weights=w_st, device=dev)

    t0 = time.perf_counter()
    (keep_r, res_r), iters = filter_iterations(robust)
    torch.cuda.synchronize()
    t_rob = time.perf_counter() - t0
    keep_again = robust()[0]
    t0 = time.perf_counter()
    work = device_work(robust)
    t_traced = time.perf_counter() - t0
    ang = np.degrees(res_r.residual_angles)
    log(f"[smoke] scene D filter_pairs on all {len(scD.pairs)} stored pairs "
        f"({int(scD.corrupted.sum())} corrupted; decomposed in {t_dec:.2f} "
        f"s): {t_rob:.3f} s ({t_traced:.1f} s traced), iterations {iters}, "
        f"{work['launches']} kernel "
        f"launches, {work['scalar_reads']} scalar reads, "
        f"{work['d2h_copies']} device-to-host copies; residuals: clean "
        f"{ang[~scD.corrupted].max():.4f} deg at most, corrupted "
        f"{ang[scD.corrupted].min():.2f} deg at least; "
        f"{int((keep_r != ~scD.corrupted).sum())} pairs misjudged")
    if not np.array_equal(keep_r, ~scD.corrupted):
        raise AssertionError("scene D filter_pairs on the stored pairs: the "
                             "mask is not the clean pairs")
    if not np.array_equal(keep_again, keep_r):
        raise AssertionError("scene D filter_pairs: two calls' masks differ")

    # lifting with GT depth, then XM^2 dense (its defaults) and implicit
    t0 = time.perf_counter()
    vg = build_view_graph(exp.matches, N=exp.N, M=exp.M)
    lifted = lift_dataset(vg, lambda i: scene_d_depth(scD, i),
                          lambda i: scD.K)
    log(f"[smoke] scene D lifting: {time.perf_counter() - t0:.2f} s, "
        f"{len(lifted[0])} observations, {vg.N} frames, {vg.M} tracks")
    R_gt = scD.R.transpose(0, 2, 1)
    for tag, kw, ref in (
            ("dense", XM2_D_ARGS["dense"], XM2_D["dense"]),
            ("implicit", XM2_D_ARGS["implicit"], XM2_D["implicit"]),
            ("implicit default tol", dict(implicit=True), XM2_D_DEFAULT)):
        reset_counts()
        out, last, ranks, timer, wall = run_xm2_d(xm2, lifted, vg.N, vg.M,
                                                  dev, **kw)
        counts[f"D {tag}"] = read_counts()
        rot = rotation_error_stats(out.R_real, R_gt, out.indices_all)
        m = scene_d_report(out, scD)
        log(f"[smoke] scene D xm2_solve {tag}: wall {wall:.2f} s, ranks "
            f"{ranks}, certified {last.certified} at rank {last.rank}, "
            f"primal {last.primal!r} (JAX package {ref['primal']!r}, "
            f"rank {ref['rank']}), lam {out.lam}, rotation errors {rot} "
            f"(JAX package {ref['rot']}); ATE/RPE "
            f"{ {k: float(v) for k, v in m.items()} }; launches "
            f"{counts[f'D {tag}']}; phases:")
        for line in timer.report().splitlines():
            log(f"[smoke]   {line}")
        if ref is XM2_D_DEFAULT:
            hold_default_tol(xm2, out, last, dev)
            continue
        if not (last.certified and last.rank == ref["rank"]):
            raise AssertionError(f"scene D {tag}: not certified at rank "
                                 f"{ref['rank']}")
        if abs(last.primal - ref["primal"]) > RTOL_IMPLICIT * ref["primal"]:
            raise AssertionError(f"scene D {tag}: primal {last.primal} vs "
                                 f"{ref['primal']}")
        check_rotations(f"scene D {tag}", rot, ref["rot"])
    if counts["D implicit"]["sorted_segment_sum"] <= 0:
        raise AssertionError("scene D implicit: sorted_segment_sum never "
                             "launched")

    # view-graph calibration on the card
    F, cam0, cam1, pp, f0 = scene_d_calibration_inputs(scD)
    t0 = time.perf_counter()
    cal = calibrate_view_graph(F, cam0, cam1, pp, f0, prior_mask=[False],
                               device=dev)
    f_cal = float(cal["focals"][0])
    log(f"[smoke] scene D calibrate_view_graph ({len(F)} pairs, from "
        f"{f0[0]}): focal {f_cal!r} (JAX package {CALIB_D!r}), "
        f"{int(cal['pair_valid'].sum())} pairs valid, "
        f"{time.perf_counter() - t0:.2f} s")
    f_true = SCENE_D_CAMERA["f"]
    if not (abs(f_cal - f_true) <= 0.01 * f_true
            and abs(f_cal - CALIB_D) <= 1e-6 * CALIB_D):
        raise AssertionError(f"scene D calibration: focal {f_cal}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    return run(torch.device("cuda"), card_line())


def run(dev, card: str) -> int:
    import torch

    import xmtpu_torch  # noqa: F401  (sets the TF32 switches)
    from xmtpu_torch import _build
    from xmtpu_torch.ops import fused_tcg as ft
    from xmtpu_torch.ops import manifold as mf
    from xmtpu_torch.ops.qop import DenseQ, cast_qop
    from xmtpu_torch.solver import trust_region as tr
    from xmtpu_torch.ops.schurq import SchurQ
    from xmtpu_torch.pipeline import xm2
    from xmtpu_torch.pipeline.synthetic import make_scene, make_scene_window
    from xmtpu_torch.solver.certificate import certify
    from xmtpu_torch.solver.staircase import solve_arrays
    from xmtpu_torch.utils.timer import PhaseTimer

    log(f"[smoke] card: {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda} numpy {np.__version__}")

    # ---- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    report = _build.build_all()
    log(f"[smoke] build: {time.perf_counter() - t0:.1f} s "
        f"({', '.join(report) or 'cached'})")
    for name, r in report.items():
        for line in r["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"[ptxas {name}] {line.strip()}")

    # ---- 2. kernels vs plain ---------------------------------------------
    lam = 0.0
    f32 = torch.float32
    C_A, gen_A, asm_A = scene(SCENE_A, dev)
    nA = C_A.shape[0] // 3
    qA, qA32 = DenseQ(C_A), DenseQ(C_A.to(f32))
    cases = []
    R3 = mf.identity_frames(nA, 3, device=dev)
    ones = torch.ones((nA,), dtype=torch.float64, device=dev)
    cases.append(("A o=3", qA, f32_phase_inputs(qA32, R3, ones), True))
    # later in the phase the Steihaug loop runs tens of iterations before
    # its superlinear stop (the first outer iteration stops at the boundary)
    cases.append((f"A o=3 outer {LONG_A}", qA,
                  f32_phase_inputs(qA32, R3, ones, LONG_A), True))
    # the rank-4 stage's start: rank-3 solution + escape linesearch
    r3 = solve_arrays(C_A, max_rank=3, tol=1e-6, precision="mixed",
                      inner_f32=True, verbose=False, device=dev)
    R3s = torch.as_tensor(r3.R, device=dev).reshape(nA, 3, 3)
    s3 = torch.as_tensor(r3.s_ex, device=dev)
    cert = certify(C_A, mf.flatten(mf.scale_blocks(R3s, s3)), lam, r3.primal,
                   device=dev)
    esc = (cert.v.reshape(nA, 3) / s3[:, None]).reshape(-1)
    R4 = torch.cat([R3s, torch.zeros((nA, 3, 1), dtype=torch.float64,
                                      device=dev)], dim=2)
    R4, _f, ok = tr._escape_linesearch(C_A, R4, s3, esc, 1.0, lam,
                                       tr.TRConfig())
    if not ok:
        raise AssertionError("scene A escape linesearch failed")
    cases.append(("A o=4", qA, f32_phase_inputs(qA32, R4, s3), True))
    del qA32
    C_512, _, _ = scene(SCENE_512, dev)
    n512 = C_512.shape[0] // 3
    cases.append(("n512 o=3", DenseQ(C_512), f32_phase_inputs(
        DenseQ(C_512.to(f32)), mf.identity_frames(n512, 3, device=dev),
        torch.ones((n512,), dtype=torch.float64, device=dev)), True))
    del C_512
    C_B, gen_B, asm_B = scene(SCENE_B, dev)
    nB = C_B.shape[0] // 3
    qB, qB32 = DenseQ(C_B), DenseQ(C_B.to(f32))
    RB = mf.identity_frames(nB, 3, device=dev)
    onesB = torch.ones((nB,), dtype=torch.float64, device=dev)
    cases.append(("B o=3", qB, f32_phase_inputs(qB32, RB, onesB), False))
    cases.append((f"B o=3 outer {LONG_B}", qB,
                  f32_phase_inputs(qB32, RB, onesB, LONG_B), False))
    del qB32

    held = {}
    for case in cases:
        held[case[0]] = hold_case(*case)
    del cases, qA, qB

    # ---- 3. scene A: the mixed certified staircase -------------------------
    log(f"[smoke] scene A: make_scene {gen_A:.2f} s, assembly {asm_A:.3f} s")
    # the fused loops' iterations: each enqueues FLAG_EVERY launches between
    # reads of the done flag, so a loop that ran i iterations enqueued
    # FLAG_EVERY * ceil(i / FLAG_EVERY)
    fused_iters = []
    fused_loop = ft.inner_tcg_fused

    def counted_loop(*a, **k):
        r = fused_loop(*a, **k)
        fused_iters.append(r[5])
        return r

    reset_counts()
    ft.inner_tcg_fused = counted_loop
    try:
        t0 = time.perf_counter()
        res_A = solve_arrays(C_A, max_rank=6, tol=1e-6, precision="mixed",
                             inner_f32=True, verbose=True, device=dev)
        torch.cuda.synchronize()
        wall_A = time.perf_counter() - t0
    finally:
        ft.inner_tcg_fused = fused_loop
    counts = {"A": read_counts()}
    launches_A = (ft.tcg_step.launches, ft.tcg_step_dense.launches)
    enqueued_A = sum(ft.FLAG_EVERY * max(1, -(-i // ft.FLAG_EVERY))
                     for i in fused_iters)
    log(f"[smoke] scene A: rank {res_A.rank} status {res_A.status} primal "
        f"{res_A.primal!r} gap {res_A.gap:.3e} lam_min {res_A.lam_min:.3e} "
        f"outer {res_A.outer_iters} inner {res_A.total_inner} wall "
        f"{wall_A:.2f} s launches tcg_step/tcg_step_dense {launches_A}; "
        f"{len(fused_iters)} fused loops ran {sum(fused_iters)} inner "
        f"iterations and enqueued {enqueued_A}")
    for st in res_A.stages:
        log(f"[smoke] scene A stage {st}")
    if not (res_A.certified and res_A.rank == 4 and res_A.status == 1):
        raise AssertionError("scene A: not certified at rank 4")
    if abs(res_A.primal - PRIMAL_A) > RTOL_PRIMAL * PRIMAL_A:
        raise AssertionError(f"scene A primal {res_A.primal} vs {PRIMAL_A}")
    if launches_A != (0, enqueued_A) or enqueued_A <= 0:
        raise AssertionError(f"scene A: expected one tcg_step_dense launch "
                             f"for each of {enqueued_A} enqueued iterations "
                             f"and no tcg_step, got {launches_A}")
    t0 = time.perf_counter()
    res_A_cpu = solve_arrays(C_A.cpu(), max_rank=6, tol=1e-6,
                             precision="mixed", inner_f32=True,
                             verbose=False, device="cpu")
    log(f"[smoke] scene A on the CPU: rank {res_A_cpu.rank} primal "
        f"{res_A_cpu.primal!r} ({time.perf_counter() - t0:.2f} s)")
    if not (res_A_cpu.certified and res_A_cpu.rank == res_A.rank):
        raise AssertionError("scene A: CUDA and CPU runs disagree")
    if abs(res_A_cpu.primal - res_A.primal) > 1e-5 * abs(res_A.primal):
        raise AssertionError("scene A: CUDA and CPU primals disagree")

    # ---- 4. scene B: the split variant -------------------------------------
    log(f"[smoke] scene B: make_scene {gen_B:.2f} s, assembly {asm_B:.3f} s")
    reset_counts()
    t0 = time.perf_counter()
    res_B = solve_arrays(C_B, max_rank=6, tol=1e-3, precision="mixed",
                         inner_f32=True, verbose=True, device=dev)
    torch.cuda.synchronize()
    wall_B = time.perf_counter() - t0
    counts["B"] = read_counts()
    launches_B = (ft.tcg_step.launches, ft.tcg_step_dense.launches)
    log(f"[smoke] scene B: rank {res_B.rank} status {res_B.status} primal "
        f"{res_B.primal!r} gap {res_B.gap:.3e} lam_min {res_B.lam_min:.3e} "
        f"outer {res_B.outer_iters} inner {res_B.total_inner} wall "
        f"{wall_B:.2f} s launches tcg_step/tcg_step_dense {launches_B}")
    for st in res_B.stages:
        log(f"[smoke] scene B stage {st}")
    if not (res_B.certified and res_B.rank == 3 and res_B.status == 1):
        raise AssertionError("scene B: not certified at rank 3")
    if abs(res_B.primal - PRIMAL_B) > RTOL_PRIMAL * PRIMAL_B:
        raise AssertionError(f"scene B primal {res_B.primal} vs {PRIMAL_B}")
    if launches_B[0] <= 0 or launches_B[1] != 0:
        raise AssertionError(f"scene B: expected split-variant launches only, "
                             f"got tcg_step/tcg_step_dense {launches_B}")

    del C_A, C_B

    # ---- 5. scene C: the operator choice, and the segment-sum kernels -------
    t0 = time.perf_counter()
    scC = make_scene_window(**SCENE_C)
    gen_C = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    Q_C, Abar_C, impl_C = xm2._assemble_operator(
        scC.weights, scC.edges, scC.landmarks, True, "auto", device=dev)
    torch.cuda.synchronize()
    asm_C = time.perf_counter() - t0
    log(f"[smoke] scene C: n={scC.N} m={scC.M} E={len(scC.edges)}; "
        f"make_scene_window {gen_C:.2f} s, SchurQ build {asm_C:.2f} s, "
        f"device memory peak of the build "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if not (impl_C and isinstance(Q_C, SchurQ) and Abar_C is None):
        raise AssertionError(f"scene C: the operator choice took "
                             f"{type(Q_C).__name__}, not SchurQ")
    seg_cases = hold_segsum(Q_C, dev)
    for c in seg_cases:
        log(f"[smoke] segsum {c['tag']}: err {c['max_abs_err']:.2e} "
            f"(rel {c['max_rel_err']:.1e}) {c['ms']:.4f} ms plain "
            f"{c['plain_ms']:.4f} ms index_add_ {c['library_ms']:.4f} ms "
            f"bound {c['bound'][0]:.5f} ms ({c['bound'][1]})")
    # tcg_step at the implicit size: the split variant on the f32 cast of
    # Q_C, the f64 loop on Q_C itself
    nC = scC.N
    qC32 = cast_qop(Q_C, f32)
    RC = mf.identity_frames(nC, 3, device=dev)
    onesC = torch.ones((nC,), dtype=torch.float64, device=dev)
    for tag, outer in (("C o=3", 0), (f"C o=3 outer {LONG_C}", LONG_C)):
        held[tag] = hold_case(tag, Q_C, f32_phase_inputs(qC32, RC, onesC,
                                                         outer), False)
    if held[f"C o=3 outer {LONG_C}"]["loop"][1] < LONG_C_ITERS:
        raise AssertionError(f"scene C outer {LONG_C}: the Steihaug loop ran "
                             f"{held[f'C o=3 outer {LONG_C}']['loop']}, "
                             f"expected at least {LONG_C_ITERS} inner "
                             f"iterations")
    del qC32

    # ---- 6. scene B through the implicit operator ---------------------------
    scB = make_scene(**SCENE_B)
    carried = hold_carried_operator(scB, dev)
    log(f"[smoke] scene B SchurQ built on the host, moved to the card: "
        f"kernel launched, bits repeat; (card, host) relative distance from "
        f"the exact host apply {carried}")
    t0 = time.perf_counter()
    Q_B = SchurQ.build(scB.weights, scB.edges, scB.landmarks, device=dev)
    torch.cuda.synchronize()
    build_B = time.perf_counter() - t0
    reset_counts()
    t0 = time.perf_counter()
    res_Bi = solve_arrays(Q_B, max_rank=6, tol=1e-3, precision="mixed",
                          inner_f32=True, edge_tf=True, verbose=True,
                          device=dev)
    torch.cuda.synchronize()
    wall_Bi = time.perf_counter() - t0
    counts["B implicit"] = read_counts()
    log(f"[smoke] scene B implicit: build {build_B:.2f} s; rank {res_Bi.rank} "
        f"status {res_Bi.status} primal {res_Bi.primal!r} (reference "
        f"{PRIMAL_B_IMPLICIT!r}; {res_Bi.primal / DENSE_ANCHOR_B - 1:+.3e} "
        f"from the dense anchor) gap {res_Bi.gap:.3e} lam_min "
        f"{res_Bi.lam_min:.3e} outer {res_Bi.outer_iters} inner "
        f"{res_Bi.total_inner} wall {wall_Bi:.2f} s launches "
        f"{counts['B implicit']}")
    for st in res_Bi.stages:
        log(f"[smoke] scene B implicit stage {st}")
    if not (res_Bi.certified and res_Bi.rank == 3 and res_Bi.status == 1
            and not res_Bi.stages[-1]["fused"]):
        raise AssertionError("scene B implicit: not certified at rank 3 by "
                             "the matvec certificate")
    if abs(res_Bi.primal - PRIMAL_B_IMPLICIT) > (RTOL_IMPLICIT
                                                 * PRIMAL_B_IMPLICIT):
        raise AssertionError(f"scene B implicit primal {res_Bi.primal} vs "
                             f"{PRIMAL_B_IMPLICIT}")
    del Q_B

    # ---- 7. scene C: xm2's solve and recovery -------------------------------
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    res_C, rec_C = xm2._solve_recover(Q_C, None, True, 5, 1e-1, 0.0, 1000.0,
                                      True, "mixed", device=dev)
    torch.cuda.synchronize()
    wall_C = time.perf_counter() - t0
    counts["C"] = read_counts()
    rot_C = rotation_error_stats(rec_C[0], scC.R_gt)
    log(f"[smoke] scene C: rank {res_C.rank} status {res_C.status} primal "
        f"{res_C.primal!r} (reference {PRIMAL_C!r}) gap {res_C.gap:.3e} "
        f"lam_min {res_C.lam_min:.3e} outer {res_C.outer_iters} inner "
        f"{res_C.total_inner}; solve+recover wall {wall_C:.2f} s; rotation "
        f"errors {rot_C} (reference {ROT_C}); launches {counts['C']}; "
        f"device memory peak of the solve "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for st in res_C.stages:
        log(f"[smoke] scene C stage {st}")
    if not (res_C.certified and res_C.rank == 3 and res_C.status == 1):
        raise AssertionError("scene C: not certified at rank 3")
    if abs(res_C.primal - PRIMAL_C) > RTOL_IMPLICIT * PRIMAL_C:
        raise AssertionError(f"scene C primal {res_C.primal} vs {PRIMAL_C}")
    check_rotations("scene C", rot_C, ROT_C)
    if counts["C"]["sorted_segment_sum"] <= 0 or counts["C"]["tcg_step"] <= 0:
        raise AssertionError(f"scene C: a kernel never launched {counts['C']}")
    # tcg_step's device time inside the solve, where a SchurQ apply runs
    # between its launches (a second, traced solve; as chip_profile.py reads)
    step_in_C = kernel_mean_ms(lambda: xm2._solve_recover(
        Q_C, None, True, 5, 1e-1, 0.0, 1000.0, False, "mixed", device=dev),
        "tcg_step_kernel")
    log(f"[smoke] scene C traced solve: tcg_step {step_in_C[0]:.4f} ms a "
        f"launch over {step_in_C[1]} launches")
    del Q_C

    # ---- 8. xm2_solve(implicit=True) on scene B ----------------------------
    timer = PhaseTimer()
    reset_counts()
    t0 = time.perf_counter()
    res_X = xm2.xm2_solve(scB.edges.copy(), scB.weights.copy(),
                          scB.landmarks.copy(), scB.rgbs.copy(), scB.N,
                          scB.M, implicit=True, verbose=False, timer=timer,
                          device=dev)
    torch.cuda.synchronize()
    wall_X = time.perf_counter() - t0
    counts["xm2 B"] = read_counts()
    rot_X = rotation_error_stats(res_X.R_real, scB.R_gt, res_X.indices_all)
    log(f"[smoke] xm2_solve(implicit=True) scene B: wall {wall_X:.2f} s, lam "
        f"{res_X.lam}, rotation errors {rot_X} (reference {ROT_XM2_B}); "
        f"launches {counts['xm2 B']}; phases:")
    for line in timer.report().splitlines():
        log(f"[smoke]   {line}")
    check_rotations("xm2_solve scene B", rot_X, ROT_XM2_B)

    # ---- 9. scene D: database -> mapper -> lifting -> XM^2 ----------------
    # the phase's own peak: above what phases 1-8 still hold when it starts
    torch.cuda.reset_peak_memory_stats()
    held_before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    run_scene_d(dev, counts)
    log(f"[smoke] scene D: phase wall {time.perf_counter() - t0:.1f} s, "
        f"device memory peak "
        f"{(torch.cuda.max_memory_allocated() - held_before) / 2**30:.3f} "
        f"GiB above the {held_before / 2**30:.3f} GiB held when it started")

    # ---- 10. report -----------------------------------------------------------
    a, b, c = held["A o=3"], held["B o=3"], held["C o=3"]
    dense_cases = [r for r in held.values() if "dense_ms" in r]
    step_err = worst([r[k] for r in held.values() if "dense_ms" not in r
                      for k in ("step_err", "loop_err")])
    dense_err = worst([r[k] for r in dense_cases
                       for k in ("cw_err", "step_err", "loop_err")])

    def total(name):
        return sum(run[name] for run in counts.values())

    shapes = {}
    for run in counts.values():
        for k, v in run["sorted_segment_sum shapes"].items():
            shapes[k] = shapes.get(k, 0) + v

    def seg_row(kind, name, replaces, D):
        mine = [c for c in seg_cases if c["kernel"] == kind]
        rep = next(c for c in mine if c["order"] == "l" and c["D"] == D
                   and c["dtype"] == "float32")
        return dict(
            name=name, route="cuda", source="xmtpu_torch/csrc/segsum.cu",
            replaces=replaces, launches=total(name),
            max_abs_err=max(c["max_abs_err"] for c in mine),
            max_rel_err=max(c["max_rel_err"] for c in mine),
            ms=rep["ms"], plain_ms=rep["plain_ms"],
            bound_ms=rep["bound"][0], bound_by=rep["bound"][1],
            library_ms=rep["library_ms"],
            shape=f"scene C landmark ordering, E={rep_E}, S={n_land}, D={D} "
                  f"f32; all {len(mine)} cases on the [smoke] segsum lines")

    rep_E, n_land = len(scC.edges), scC.M
    d512 = held["n512 o=3"]
    csr_row = seg_row("csr", "sorted_segment_sum",
                      "xmtpu/ops/pallas_segsum.py:46", 3)
    csr_row["shapes"] = shapes
    kernels = [
        dict(name="tcg_step", route="cuda",
             source="xmtpu_torch/csrc/fused_tcg.cu",
             replaces="xmtpu/ops/pallas_tcg.py:98",
             launches=total("tcg_step"),
             max_abs_err=step_err[0], max_rel_err=step_err[1],
             ms=c["step_ms"], enqueue_ms=c["step_enqueue_ms"],
             plain_ms=c["step_plain_ms"],
             bound_ms=c["step_bound"][0], bound_by=c["step_bound"][1],
             library_ms=None, solve_ms=step_in_C[0],
             geometry=c["geometry"],
             shape=f"n={scC.N} o=3 (scene C, split variant on the f32 cast "
                   f"of SchurQ); solve_ms: mean over the {step_in_C[1]} "
                   f"launches of a traced scene C solve; scene B n={nB}: "
                   f"{b['step_ms']:.4f} ms, bound {b['step_bound'][0]:.5f}, "
                   f"{b['geometry']}; scene A n={nA}: {a['step_ms']:.4f} ms, "
                   f"bound {a['step_bound'][0]:.6f}, {a['step_geometry']}"),
        dict(name="tcg_step_dense", route="cuda",
             source="xmtpu_torch/csrc/fused_tcg.cu",
             replaces="xmtpu/ops/pallas_tcg.py:109",
             launches=total("tcg_step_dense"),
             max_abs_err=dense_err[0], max_rel_err=dense_err[1],
             ms=a["dense_ms"], enqueue_ms=a["dense_enqueue_ms"],
             plain_ms=a["dense_plain_ms"],
             bound_ms=a["dense_bound"][0], bound_by=a["dense_bound"][1],
             library_ms=a["cw_library_ms"], geometry=a["geometry"],
             shape=f"n={nA} o=3 (scene A); library_ms: torch.matmul of the "
                   f"product alone on the same W; n=512: "
                   f"{d512['dense_ms']:.4f} ms, bound "
                   f"{d512['dense_bound'][0]:.5f}, matmul "
                   f"{d512['cw_library_ms']:.4f} ms, {d512['geometry']}"),
        csr_row,
        seg_row("blocked", "sorted_segment_sum_blocked",
                "xmtpu/ops/pallas_segsum.py:222", 6),
    ]
    log(f"[smoke] launches per main-path run: {counts}")
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
