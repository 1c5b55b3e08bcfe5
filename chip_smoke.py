#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``xmtpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase is caught):

1. build the CUDA kernels from ``xmtpu_torch/csrc`` (nvcc, all at once);
2. hold each kernel against its plain PyTorch version on the card, on real
   f32-phase inputs (the first outer iteration of a stage, and one later in
   the phase where the Steihaug loop runs long): one inner iteration and a
   whole Steihaug loop, and time both versions beside the kernel's bound;
3. scene A (n=120, the saddle-escape anchor): dense assembly on the card and
   the mixed certified staircase, which must certify at rank 4 through the
   dense kernel variant and match the port's own CPU run;
4. scene B (n=1934): the same through the split variant, certified at
   rank 3;
5. print the kernels' JSON line, the card's name and power limit, and the
   contract line ``{"ok": true, "device": {...}}`` last.

A kernel's ``ms`` is its time on the card per launch (profiler durations);
``enqueue_ms`` is the rate at which back-to-back calls of its Python wrapper
complete (CUDA events), which the host bounds at these sizes; ``plain_ms``
is the plain version's time per call by CUDA events, its host syncs
included; ``library_ms`` is the card's time for ``torch.matmul`` on the
same W.

Imports nothing of JAX or of the JAX package.
"""

import json
import os
import subprocess
import sys
import time

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
# the largest scene the dense variant's gate admits (n <= 512)
SCENE_512 = dict(n_cameras=512, n_points=2048, obs_per_camera=60, noise=1e-3,
                 seed=0)
RTOL_PRIMAL = 1e-4
# f32-phase outer iterations after which the Steihaug loop runs long (on
# the host: 54 iterations at scene A, 12 at scene B)
LONG_A, LONG_B = 85, 56

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s and
# f32 FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
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
    do not count."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def busy_us(with_fn):
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
        return sum(e.time_range.end - e.time_range.start
                   for e in prof.events() if e.device_type == DeviceType.CUDA)

    base = busy_us(False) if setup else 0.0
    return max(busy_us(True) - base, 0.0) / reps / 1e3


def f32_phase_inputs(C, R, s_ex, outer: int = 0, lam=0.0):
    """Real inputs of ``fused_tcg.inner_tcg_fused``: the mixed ladder's f32
    phase started at (R, s_ex) is run for ``outer`` outer iterations, and
    its next outer iteration's tCG arguments are computed as
    ``_outer_step`` does (``outer=0``: the phase's first outer
    iteration)."""
    import torch

    from xmtpu_torch.ops import manifold as mf
    from xmtpu_torch.ops.qop import DenseQ
    from xmtpu_torch.solver import trust_region as tr

    f32 = torch.float32
    q = DenseQ(C.to(f32))
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
    m = 3 * n
    nbytes = F32 * (m * m + 2 * 3 * o * n + 2 * n + 8 + 3 * o * n)
    ops = 2 * m * m * o + 3 * 3 * o * n
    return nbytes, ops


def bound_ms(nbytes, ops):
    tb, to = nbytes / PEAK_BYTES * 1e3, ops / PEAK_F32 * 1e3
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


def f64_loop(C, inp):
    """The Steihaug loop of ``inp`` in float64 through the generic path:
    ``(vR, vs, hvR, hvs, endreason, iters)``."""
    import torch

    from xmtpu_torch.ops import manifold as mf
    from xmtpu_torch.ops.qop import DenseQ
    from xmtpu_torch.solver import trust_region as tr

    q = DenseQ(C)
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


def hold_kernels(C, inp, tag, with_cw: bool):
    """One iteration and a whole Steihaug loop: kernel vs plain on the card.
    Returns the max errors and the timings of this case."""
    import torch

    from xmtpu_torch.ops import fused_tcg as ft
    from xmtpu_torch.ops import manifold as mf

    R = inp["R"]
    n, _, o = R.shape
    max_inner = int(inp["cfg"].max_inner)
    args = {k: inp[k] for k in ("R", "s_ex", "CsR", "egR", "egs", "pgR",
                                 "pgs", "gradnorm", "delta", "lam", "cfg",
                                 "minv")}
    const, state, sc, cfgsc = ft.prepare(**args)
    C32 = ft.dense_matrix(inp["qmul"], n) if with_cw else None
    if not with_cw:
        Wf = mf.flatten(ft.from_t(state[4] * const["s_ex_t"]
                                     + const["Rt"] * state[5], n, o))
        const["CWt"].copy_(ft.to_t(mf.unflatten(2.0 * inp["qmul"](Wf))))
    out = {}

    # --- one iteration --------------------------------------------------
    def clone_all():
        c = {k: v.clone() for k, v in const.items()}
        return c, tuple(t.clone() for t in state), sc.clone()

    ck, sk, sck = clone_all()
    cp, sp, scp = clone_all()
    if with_cw:
        ft.tcg_cw_dense(C32, ck["Rt"], ck["s_ex_t"], sk[4], sk[5], sck,
                        ck["CWt"], max_inner)
        ft.tcg_cw_dense_plain(C32, cp["Rt"], cp["s_ex_t"], sp[4], sp[5], scp,
                              cp["CWt"], max_inner)
        torch.cuda.synchronize()
        scale = max(1e-3, float(cp["CWt"].abs().max()))
        out["cw_err"] = assert_close(f"{tag} tcg_cw_dense CW", ck["CWt"],
                                     cp["CWt"], 5e-4 * scale, 5e-3)
        # feed both steps the same product
        ck["CWt"].copy_(cp["CWt"])
    ft.tcg_step(*ck.values(), *sk, sck, cfgsc, max_inner)
    ft.tcg_step_plain(*cp.values(), *sp, scp, cfgsc, max_inner)
    torch.cuda.synchronize()
    sc_k, sc_p = sck.tolist(), scp.tolist()
    if [sc_k[i] for i in (ft.S_ER, ft.S_DONE, ft.S_I)] != \
            [sc_p[i] for i in (ft.S_ER, ft.S_DONE, ft.S_I)]:
        raise AssertionError(f"{tag} tcg_step carry: kernel {sc_k} vs "
                             f"plain {sc_p}")
    # the step v (and its scale part) at the v tolerance, everything derived
    # from the Hessian product at the Hv tolerance
    errs = [assert_close(f"{tag} tcg_step carry", sck[:ft.S_ER],
                         scp[:ft.S_ER], 0.0, 5e-3)]
    names = ("vR", "vs", "rR", "rs", "pR", "ps", "hvR", "hvs")
    for nm, a, b in zip(names, sk, sp):
        at, rt = (2e-4, 2e-3) if nm in ("vR", "vs") else (5e-4, 5e-3)
        scale = max(1e-3, float(b.abs().max()))
        errs.append(assert_close(f"{tag} tcg_step {nm}", a, b, at * scale, rt))
    out["step_err"] = worst(errs)

    # --- the whole Steihaug loop -----------------------------------------
    res_k = ft.inner_tcg_fused(inp["qmul"], **args)
    cp, sp, scp = {k: v.clone() for k, v in const.items()}, \
        tuple(t.clone() for t in state), sc.clone()
    for _ in range(max_inner):
        if with_cw:
            ft.tcg_cw_dense_plain(C32, cp["Rt"], cp["s_ex_t"], sp[4], sp[5],
                                  scp, cp["CWt"], max_inner)
        else:
            Wf = mf.flatten(ft.from_t(sp[4] * cp["s_ex_t"]
                                         + cp["Rt"] * sp[5], n, o))
            cp["CWt"].copy_(ft.to_t(mf.unflatten(2.0 * inp["qmul"](Wf))))
        ft.tcg_step_plain(*cp.values(), *sp, scp, cfgsc, max_inner)
        if ft._stopped(scp, max_inner):
            break
    car = scp.tolist()
    res_p = (ft.from_t(sp[0], n, o), ft.unpack_s(sp[1], n),
             ft.from_t(sp[6], n, o), ft.unpack_s(sp[7], n),
             int(car[ft.S_ER]), int(car[ft.S_I]))
    # How far f32 rounding alone moves this loop: the plain loop against the
    # same loop in f64.  Where that is within the f32 tolerance (a
    # well-separated problem) the kernel must match the plain version to the
    # tolerance, end reason and iteration count included.  Where it is not
    # (near a saddle, every f32 summation order ends elsewhere), the kernel
    # must be no further from the f64 loop than twice the plain version is.
    res_64 = f64_loop(C, inp)
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
        dk = rel_gap(res_k, res_64)
        if not dk <= 2.0 * d64 + 2e-3:
            raise AssertionError(f"{tag} Steihaug loop: kernel {dk:.3e} from "
                                 f"the f64 loop, plain {d64:.3e}")
        out["loop_err"] = (max(float((a - b).abs().max())
                               for a, b in zip(res_k[:4], res_p[:4])),
                           rel_gap(res_k, res_p))

    # --- timings -----------------------------------------------------------
    ck, sk, sck = clone_all()
    sc0 = sc.clone()
    reps = 200
    reset = lambda: sck.copy_(sc0)  # noqa: E731 — a live carry every launch
    step = lambda: ft.tcg_step(*ck.values(), *sk, sck, cfgsc,  # noqa: E731
                               max_inner)
    out["step_ms"] = device_ms(step, reps, setup=reset)
    out["step_enqueue_ms"] = cuda_ms(step, reps, setup=reset)
    ck, sk, sck = clone_all()
    out["step_plain_ms"] = cuda_ms(
        lambda: ft.tcg_step_plain(*ck.values(), *sk, sck, cfgsc, max_inner),
        20, setup=reset)
    out["step_bound"] = bound_ms(*step_bytes_ops(n, o))
    if with_cw:
        ck, sk, sck = clone_all()
        cw = lambda: ft.tcg_cw_dense(  # noqa: E731
            C32, ck["Rt"], ck["s_ex_t"], sk[4], sk[5], sck, ck["CWt"],
            max_inner)
        out["cw_ms"] = device_ms(cw, reps)
        out["cw_enqueue_ms"] = cuda_ms(cw, reps)
        out["cw_plain_ms"] = cuda_ms(lambda: ft.tcg_cw_dense_plain(
            C32, ck["Rt"], ck["s_ex_t"], sk[4], sk[5], sck, ck["CWt"],
            max_inner), 50)
        # the library yardstick: the product alone, on this call's W
        Wf = mf.flatten(ft.from_t(sk[4] * ck["s_ex_t"] + ck["Rt"] * sk[5],
                                  n, o)).contiguous()
        out["cw_library_ms"] = device_ms(lambda: torch.matmul(C32, Wf),
                                         reps)
        out["cw_bound"] = bound_ms(*cw_bytes_ops(n, o))
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
    from xmtpu_torch.solver import trust_region as tr
    from xmtpu_torch.solver.certificate import certify
    from xmtpu_torch.solver.staircase import solve_arrays

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
    C_A, gen_A, asm_A = scene(SCENE_A, dev)
    nA = C_A.shape[0] // 3
    cases = []
    R3 = mf.identity_frames(nA, 3, device=dev)
    ones = torch.ones((nA,), dtype=torch.float64, device=dev)
    cases.append(("A o=3", C_A, f32_phase_inputs(C_A, R3, ones), True))
    # later in the phase the Steihaug loop runs tens of iterations before
    # its superlinear stop (the first outer iteration stops at the boundary)
    cases.append((f"A o=3 outer {LONG_A}", C_A,
                  f32_phase_inputs(C_A, R3, ones, LONG_A), True))
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
    cases.append(("A o=4", C_A, f32_phase_inputs(C_A, R4, s3), True))
    C_512, _, _ = scene(SCENE_512, dev)
    n512 = C_512.shape[0] // 3
    cases.append(("n512 o=3", C_512, f32_phase_inputs(
        C_512, mf.identity_frames(n512, 3, device=dev),
        torch.ones((n512,), dtype=torch.float64, device=dev)), True))
    del C_512
    C_B, gen_B, asm_B = scene(SCENE_B, dev)
    nB = C_B.shape[0] // 3
    RB = mf.identity_frames(nB, 3, device=dev)
    onesB = torch.ones((nB,), dtype=torch.float64, device=dev)
    cases.append(("B o=3", C_B, f32_phase_inputs(C_B, RB, onesB), False))
    cases.append((f"B o=3 outer {LONG_B}", C_B,
                  f32_phase_inputs(C_B, RB, onesB, LONG_B), False))

    held = {}
    for tag, C, inp, with_cw in cases:
        r = hold_kernels(C, inp, tag, with_cw)
        held[tag] = r
        msg = (f"[smoke] {tag}: step err {r['step_err'][1]:.1e} loop "
               f"(endreason, iters)={r['loop']} err {r['loop_err'][1]:.1e} "
               f"(f32 vs f64 loop {r['loop_f64_gap']:.1e}); "
               f"tcg_step {r['step_ms']:.4f} ms (enqueue "
               f"{r['step_enqueue_ms']:.4f}) plain {r['step_plain_ms']:.4f} "
               f"ms bound {r['step_bound'][0]:.5f}")
        if with_cw:
            msg += (f"; tcg_cw_dense err {r['cw_err'][1]:.1e} "
                    f"{r['cw_ms']:.4f} ms (enqueue {r['cw_enqueue_ms']:.4f}) "
                    f"plain {r['cw_plain_ms']:.4f} ms "
                    f"matmul {r['cw_library_ms']:.4f} ms bound "
                    f"{r['cw_bound'][0]:.5f}")
        log(msg)
    del cases

    # ---- 3. scene A: the mixed certified staircase -------------------------
    log(f"[smoke] scene A: make_scene {gen_A:.2f} s, assembly {asm_A:.3f} s")
    ft.tcg_step.launches = ft.tcg_cw_dense.launches = 0
    t0 = time.perf_counter()
    res_A = solve_arrays(C_A, max_rank=6, tol=1e-6, precision="mixed",
                         inner_f32=True, verbose=True, device=dev)
    torch.cuda.synchronize()
    wall_A = time.perf_counter() - t0
    launches_A = (ft.tcg_step.launches, ft.tcg_cw_dense.launches)
    log(f"[smoke] scene A: rank {res_A.rank} status {res_A.status} primal "
        f"{res_A.primal!r} gap {res_A.gap:.3e} lam_min {res_A.lam_min:.3e} "
        f"outer {res_A.outer_iters} inner {res_A.total_inner} wall "
        f"{wall_A:.2f} s launches step/cw {launches_A}")
    for st in res_A.stages:
        log(f"[smoke] scene A stage {st}")
    if not (res_A.certified and res_A.rank == 4 and res_A.status == 1):
        raise AssertionError("scene A: not certified at rank 4")
    if abs(res_A.primal - PRIMAL_A) > RTOL_PRIMAL * PRIMAL_A:
        raise AssertionError(f"scene A primal {res_A.primal} vs {PRIMAL_A}")
    if min(launches_A) <= 0:
        raise AssertionError(f"scene A: a kernel never launched {launches_A}")
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
    ft.tcg_step.launches = ft.tcg_cw_dense.launches = 0
    t0 = time.perf_counter()
    res_B = solve_arrays(C_B, max_rank=6, tol=1e-3, precision="mixed",
                         inner_f32=True, verbose=True, device=dev)
    torch.cuda.synchronize()
    wall_B = time.perf_counter() - t0
    launches_B = (ft.tcg_step.launches, ft.tcg_cw_dense.launches)
    log(f"[smoke] scene B: rank {res_B.rank} status {res_B.status} primal "
        f"{res_B.primal!r} gap {res_B.gap:.3e} lam_min {res_B.lam_min:.3e} "
        f"outer {res_B.outer_iters} inner {res_B.total_inner} wall "
        f"{wall_B:.2f} s launches step/cw {launches_B}")
    for st in res_B.stages:
        log(f"[smoke] scene B stage {st}")
    if not (res_B.certified and res_B.rank == 3 and res_B.status == 1):
        raise AssertionError("scene B: not certified at rank 3")
    if abs(res_B.primal - PRIMAL_B) > RTOL_PRIMAL * PRIMAL_B:
        raise AssertionError(f"scene B primal {res_B.primal} vs {PRIMAL_B}")
    if launches_B[0] <= 0 or launches_B[1] != 0:
        raise AssertionError(f"scene B: expected split-variant launches only, "
                             f"got step/cw {launches_B}")

    # ---- 5. report ----------------------------------------------------------
    a, b = held["A o=3"], held["B o=3"]
    step_err = worst([r[k] for r in held.values()
                      for k in ("step_err", "loop_err")])
    cw_err = worst([r["cw_err"] for r in held.values() if "cw_err" in r])
    kernels = [
        dict(name="tcg_step", route="cuda",
             source="xmtpu_torch/csrc/fused_tcg.cu",
             replaces="xmtpu/ops/pallas_tcg.py:98",
             launches=launches_A[0] + launches_B[0],
             max_abs_err=step_err[0], max_rel_err=step_err[1],
             ms=b["step_ms"], enqueue_ms=b["step_enqueue_ms"],
             plain_ms=b["step_plain_ms"],
             bound_ms=b["step_bound"][0], bound_by=b["step_bound"][1],
             library_ms=None,
             shape=f"n={nB} o=3 (scene B); scene A n={nA}: "
                   f"{a['step_ms']:.4f} ms"),
        dict(name="tcg_cw_dense", route="cuda",
             source="xmtpu_torch/csrc/fused_tcg.cu",
             replaces="xmtpu/ops/pallas_tcg.py:109",
             launches=launches_A[1] + launches_B[1],
             max_abs_err=cw_err[0], max_rel_err=cw_err[1],
             ms=a["cw_ms"], enqueue_ms=a["cw_enqueue_ms"],
             plain_ms=a["cw_plain_ms"],
             bound_ms=a["cw_bound"][0], bound_by=a["cw_bound"][1],
             library_ms=a["cw_library_ms"],
             shape=f"n={nA} o=3 (scene A); n=512: "
                   f"{held['n512 o=3']['cw_ms']:.4f} ms"),
    ]
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
