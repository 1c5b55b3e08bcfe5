"""Riemannian trust-region solver with truncated CG (RTR-tCG).

PyTorch counterpart of ``xmtpu/solver/trust_region.py``; see that module for
the reference semantics and line map.  The reference runs the outer and inner
loops as ``lax.while_loop``s inside one jitted program; here they are host
loops over device tensors.  Arrays (frames, scales, the carried ``2 Q sR``)
stay on the device; the scalar control state (loss, trust radius, counters,
flags) lives on the host as numpy scalars of the working dtype, so every
scalar decision rounds exactly as the reference's device scalars do.

Inner-loop routing (``_inner_tcg``): an f32 carry on a CUDA device with the
block-Jacobi preconditioner goes through the fused kernels
(``ops.fused_tcg``); every other case — f64 carries, unpreconditioned runs
and every CPU run — takes the generic loop, which is the reference's CPU
branch.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from xmtpu_torch._device import resolve_device
from xmtpu_torch.ops import manifold as mf
from xmtpu_torch.ops.qop import as_qop

# done_reason codes
RUNNING = 0
DONE_GRADTOL = 1        # gradnorm < gradtol
DONE_RDOTR_SMALL = 2    # tCG residual at machine precision (endreason 5)
DONE_LOSSQU = 3         # model decrease >= 0
DONE_DELTA = 4          # trust radius collapsed
DONE_MAX_OUTER = 5
DONE_MAX_TIME = 6
DONE_LINESEARCH_FAIL = 7  # staircase abort, primal = -1

# tCG endreason codes
ER_NEGCURV = 1
ER_BOUNDARY = 2
ER_SUPERLINEAR = 3
ER_SMALL_RDOTR = 5
ER_MAX_INNER = 6


@dataclass(frozen=True)
class TRConfig:
    """Solver knobs; field meanings as in ``xmtpu.solver.trust_region``."""
    max_outer: int = 1000
    max_inner: int = 1000
    max_time: float = float("inf")   # seconds, enforced between chunks
    chunk: int = 100                 # outer iterations between host checks
    rdotr_min: float = 1e-15
    delta_min: float = 1e-20
    linesearch_alpha_min: float = 1e-20
    precondition: bool = True        # block-Jacobi tCG preconditioner
    stop_on_collapse: bool = False   # stop at a zero-accept collapse cycle
    inner_f32: bool = False          # f32 tCG Hessian applies in f64 solves
    history: int = 0                 # per-outer ring buffer rows (0 = off)

    @staticmethod
    def for_dtype(dtype, **kwargs) -> "TRConfig":
        """Reference guards assume f64; scale them to the working
        precision."""
        if dtype == torch.float32:
            kwargs.setdefault("rdotr_min", 1e-7)
            kwargs.setdefault("delta_min", 1e-18)
            kwargs.setdefault("linesearch_alpha_min", 1e-18)
        return TRConfig(**kwargs)

    def f32_ladder(self, gradtol) -> "tuple[TRConfig, float]":
        """The mixed ladder's f32-phase policy derived from this (f64)
        config.  Returns ``(cfg32, gradtol32)``."""
        cfg32 = TRConfig.for_dtype(
            torch.float32, max_outer=self.max_outer,
            max_inner=min(self.max_inner, 100),
            max_time=self.max_time, chunk=self.chunk,
            stop_on_collapse=True)
        return cfg32, max(float(gradtol), 1e-5)


def auto_chunk(n: int, default: int = 100) -> int:
    """Size-aware outer-iterations-per-chunk bound (the reference's
    schedule; chunks bound the time between deadline checks)."""
    if n <= 2000:
        return default
    if n <= 4000:
        return min(default, 25)
    return min(default, 5)


def np_dtype(dtype: torch.dtype):
    """The numpy scalar type of a working dtype."""
    return np.float32 if dtype == torch.float32 else np.float64


class TRState(NamedTuple):
    R: torch.Tensor          # (n, 3, o), on the device
    s_ex: torch.Tensor       # (n,)
    loss: np.floating        # host scalars from here on, working dtype
    delta: np.floating
    shrink_count: int
    endreason: int           # last tCG end reason
    k: int                   # outer iteration count
    total_inner: int
    gradnorm: np.floating
    done: bool
    done_reason: int
    QsR: "torch.Tensor | None" = None   # carried 2 Q sR (n, 3, o)
    collapse_count: int = 0
    accepts_since_collapse: int = 0
    hist: "np.ndarray | None" = None    # (cfg.history, 8) ring buffer


class TRResult(NamedTuple):
    R: torch.Tensor
    s_ex: torch.Tensor
    primal: float
    gradnorm: float
    outer_iters: int
    total_inner: int
    done_reason: int
    hist: "np.ndarray | None" = None
    delta: "np.floating | None" = None


_ER_NAMES = {ER_NEGCURV: "negcurv", ER_BOUNDARY: "boundary",
             ER_SUPERLINEAR: "superlin", ER_SMALL_RDOTR: "rdotr~0",
             ER_MAX_INNER: "maxinner"}


def print_history(hist, k_lo: int, k_hi: int) -> None:
    """Reference-style per-outer-iteration table from the ring buffer."""
    hist = np.asarray(hist)
    H = hist.shape[0]
    for k in range(max(int(k_lo), int(k_hi) - H), int(k_hi)):
        r = hist[k % H]
        if int(r[0]) != k:
            continue  # row never written (e.g. gradtol stop before work)
        status = {1: "TR+", 0: "REJ", -1: "BAD"}.get(int(r[6]), "?")
        er = _ER_NAMES.get(int(r[7]), str(int(r[7])))
        print(f"[tr] k={k:4d} i={int(r[1]):4d} loss={r[2]: .9e} "
              f"|g|={r[3]:.3e} rho={r[4]: .2e} delta={r[5]:.2e} "
              f"{status} {er}")


def _fetch(*xs, dt):
    """Several 0-d device tensors -> host scalars of numpy type ``dt``, in
    one transfer."""
    return tuple(dt(v) for v in torch.stack(xs).tolist())


def _inner_tcg(qmul, R, s_ex, CsR, egR, egs, pgR, pgs, gradnorm, delta, lam,
               cfg: TRConfig, minv=None):
    """Steihaug truncated-CG on the trust-region subproblem (optionally
    block-Jacobi preconditioned: ``minv = (minv_R, ms)`` from
    :func:`_build_minv`).  Returns ``(vR, vs, hvR, hvs, endreason, iters)``
    with host ints for the last two."""
    if (minv is not None and R.dtype == torch.float32
            and R.device.type == "cuda"):
        from xmtpu_torch.ops import fused_tcg

        return fused_tcg.inner_tcg_fused(qmul, R, s_ex, CsR, egR, egs, pgR,
                                         pgs, gradnorm, delta, lam, cfg, minv)
    dt = np_dtype(R.dtype)
    s = s_ex[1:]
    Segr = mf.sym3(mf.gram3(R, egR))
    delta = dt(delta)
    gradnorm = dt(gradnorm)

    def precond(rR, rs):
        minv_R, ms = minv
        zR = mf.apply3(minv_R, rR)
        S = mf.sym3(mf.gram3(R, zR))
        return zR - mf.apply3(S, R), rs / ms

    if minv is None:
        zR, zs = pgR, pgs
        (rdotr,) = _fetch(mf.inner(pgR, pgR, pgs, pgs, s), dt=dt)
        rdotz = rdotr
    else:
        zR, zs = precond(pgR, pgs)
        rdotr, rdotz = _fetch(mf.inner(pgR, pgR, pgs, pgs, s),
                              mf.inner(pgR, zR, pgs, zs, s), dt=dt)

    vR, vs = torch.zeros_like(pgR), torch.zeros_like(pgs)
    hvR, hvs = torch.zeros_like(pgR), torch.zeros_like(pgs)
    rR, rs = pgR, pgs
    pR, ps = -zR, -zs
    vdotv = vdotp = dt(0.0)
    pdotp = rdotz
    endreason = ER_MAX_INNER
    i = 0
    done = False
    while i < cfg.max_inner and not done:
        rhR, rhs = mf.rhess(qmul, R, s_ex, CsR, egR, egs, pR, ps, float(lam),
                            Segr=Segr)
        (pHp,) = _fetch(mf.inner(pR, rhR, ps, rhs, s), dt=dt)
        with np.errstate(all="ignore"):
            alpha = rdotz / pHp
            small = rdotr < dt(cfg.rdotr_min)
            negcurv = (not small) and alpha <= 0.0
            boundary_q = vdotv + dt(2.0) * alpha * vdotp + alpha * alpha * pdotp
            exceed = (not small) and (not negcurv) and boundary_q > delta * delta
            to_edge = negcurv or exceed
            normal = (not small) and (not to_edge)
            sqrt_val = np.sqrt(np.maximum(
                vdotp * vdotp + pdotp * (delta * delta - vdotv), dt(0.0)))
            tau = (-vdotp + sqrt_val) / pdotp

        coef = float(tau if to_edge else (alpha if normal else dt(0.0)))
        vR = vR + coef * pR
        vs = vs + coef * ps
        hvR = hvR + coef * rhR
        hvs = hvs + coef * rhs

        step_a = float(alpha if normal else dt(0.0))
        rR = rR + step_a * rhR
        rs = rs + step_a * rhs

        if minv is None:
            zR, zs = rR, rs
            (rdotr_new,) = _fetch(mf.inner(rR, rR, rs, rs, s), dt=dt)
            rdotz_new = rdotr_new
        else:
            zR, zs = precond(rR, rs)
            rdotr_new, rdotz_new = _fetch(mf.inner(rR, rR, rs, rs, s),
                                          mf.inner(rR, zR, rs, zs, s), dt=dt)
        with np.errstate(all="ignore"):
            superlin = normal and bool(
                np.sqrt(rdotr_new) < gradnorm * np.minimum(gradnorm, dt(0.1)))
            beta = rdotz_new / rdotz
            if normal:
                pR = -zR + float(beta) * pR
                ps = -zs + float(beta) * ps
                vdotv = vdotv + dt(2) * alpha * vdotp + alpha ** 2 * pdotp
                vdotp = beta * (vdotp + alpha * pdotp)
                pdotp = beta * beta * pdotp + rdotz_new
                rdotr = rdotr_new
                rdotz = rdotz_new

        endreason = (ER_SMALL_RDOTR if small else ER_NEGCURV if negcurv
                     else ER_BOUNDARY if exceed
                     else ER_SUPERLINEAR if superlin else ER_MAX_INNER)
        done = small or to_edge or superlin
        i += 1
    return vR, vs, hvR, hvs, endreason, i


def _build_minv(Cdiag, s_ex, lam):
    """Block-Jacobi preconditioner (see the reference's ``_build_minv``).
    Returns ``(minv (n,3,3), ms (n-1,))``: ``z_R = minv r_R`` (tangent-
    projected), ``z_s = r_s / ms``."""
    dtype, dev = Cdiag.dtype, Cdiag.device
    M = 2.0 * (s_ex * s_ex)[:, None, None] * Cdiag
    tr = torch.diagonal(M, dim1=-2, dim2=-1).sum(-1).mean() / 3.0
    tr = torch.maximum(tr, torch.tensor(1e-300, dtype=dtype, device=dev))
    M = M / tr
    eye = torch.eye(3, dtype=dtype, device=dev)
    M = M + 1e-4 * eye
    L = torch.linalg.cholesky(M)
    Linv = torch.linalg.solve_triangular(L, eye.expand(M.shape), upper=False,
                                         left=True)
    minv = torch.einsum("nka,nkb->nab", Linv, Linv)

    trC = torch.diagonal(Cdiag, dim1=-2, dim2=-1).sum(-1)[1:]
    s = s_ex[1:]
    ms_quad = 2.0 * trC
    ms = ms_quad + float(lam) * (12.0 * s * s - 4.0)
    ms = torch.maximum(ms, 0.2 * ms_quad) / tr
    ms = torch.maximum(ms, torch.tensor(1e-4, dtype=dtype, device=dev))
    # identity at lam == 0 (see the reference for the measurement)
    if not lam > 0:
        ms = torch.ones_like(ms)
    return minv, ms


def _outer_step(qmul, st: TRState, lam, gradtol, delta_bar, cfg: TRConfig,
                Cdiag=None, qmul_inner=None) -> TRState:
    """One outer TR iteration.  ``lam``, ``gradtol`` and ``delta_bar`` are
    host scalars of the working dtype."""
    if qmul_inner is None:
        qmul_inner = qmul
    dt = np_dtype(st.R.dtype)
    lam_f = float(lam)
    s = st.s_ex[1:]
    if st.QsR is None:
        egR, egs, CsR = mf.egrad_csr(qmul, st.R, st.s_ex, lam_f)
    else:
        CsR = st.QsR
        egR, egs = mf.egrad_from_csr(CsR, st.R, st.s_ex, lam_f)
    pgR, pgs = mf.project(st.R, s, egR, egs)
    (gradnorm,) = _fetch(torch.sqrt(mf.inner(pgR, pgR, pgs, pgs, s)), dt=dt)

    if gradnorm < gradtol:
        return st._replace(gradnorm=gradnorm, done=True,
                           done_reason=DONE_GRADTOL)

    minv = None if Cdiag is None else _build_minv(Cdiag, st.s_ex, lam)
    vR, vs, hvR, hvs, endreason, iters = _inner_tcg(
        qmul_inner, st.R, st.s_ex, CsR, egR, egs, pgR, pgs, gradnorm,
        st.delta, lam, cfg, minv=minv)
    total_inner = st.total_inner + iters

    # <v, Hv>/2 + <v, g> folded into ONE metric reduction pass
    loss_qu = mf.inner(vR, 0.5 * hvR + pgR, vs, 0.5 * hvs + pgs, s)
    R_new, s_ex_new = mf.retract(st.R, st.s_ex, vR, vs, 1.0)
    sR_new = mf.flatten(mf.scale_blocks(R_new, s_ex_new))
    dfdsR_new = mf.unflatten(2.0 * qmul(sR_new))
    s_new = s_ex_new[1:]
    loss_new = (0.5 * mf.vdot(mf.flatten(dfdsR_new), sR_new)
                + lam_f * torch.sum((s_new * s_new - 1.0) ** 2))
    loss_qu, loss_new = _fetch(loss_qu, loss_new, dt=dt)

    with np.errstate(all="ignore"):
        bad_model = bool(loss_qu >= 0.0)
        rho = (loss_new - st.loss) / loss_qu
        shrink = bool(rho < dt(0.25))
        expand = bool(rho > dt(0.75)) and endreason <= ER_BOUNDARY
        if shrink:
            delta = st.delta * dt(0.25)
        elif expand:
            delta = np.minimum(st.delta * dt(2.0), delta_bar)
        else:
            delta = st.delta
        shrink_count = st.shrink_count + 1 if shrink else 0
        collapse = shrink_count > 3
        if collapse:
            delta = delta * dt(1e-3)
            shrink_count = 0
        delta_dead = collapse and bool(delta < dt(cfg.delta_min))
        # rejection keeps the previous iterate; a dead radius keeps the step
        reject = (bool(loss_new > st.loss) or bool(rho < dt(0.1))) \
            and not delta_dead
    keep_new = (not bad_model) and (not reject)
    if cfg.stop_on_collapse:
        # zero-accept collapse-to-collapse cycle: the operator noise floor
        early_stop = (collapse and (not keep_new) and st.collapse_count > 0
                      and st.accepts_since_collapse == 0)
        collapse_count = st.collapse_count + int(collapse)
    else:
        early_stop = False
        collapse_count = st.collapse_count
    R_out = R_new if keep_new else st.R
    s_ex_out = s_ex_new if keep_new else st.s_ex
    loss_out = loss_new if keep_new else st.loss
    QsR_out = (None if st.QsR is None
               else (dfdsR_new if keep_new else st.QsR))

    hit_small = endreason == ER_SMALL_RDOTR
    done = bad_model or delta_dead or early_stop or hit_small
    done_reason = (DONE_LOSSQU if bad_model
                   else DONE_DELTA if (delta_dead or early_stop)
                   else DONE_RDOTR_SMALL if hit_small else RUNNING)
    # bad_model: no step taken; this pass's radius/shrink updates discarded
    delta_out = st.delta if bad_model else delta
    shrink_out = st.shrink_count if bad_model else shrink_count
    if cfg.stop_on_collapse:
        accepts_out = (int(keep_new) if collapse
                       else st.accepts_since_collapse + int(keep_new))
        cc_out = st.collapse_count if bad_model else collapse_count
        if bad_model:
            accepts_out = st.accepts_since_collapse
    else:
        cc_out = st.collapse_count
        accepts_out = st.accepts_since_collapse
    hist_out = st.hist
    if cfg.history:
        acc = -1 if bad_model else int(keep_new)
        hist_out = st.hist.copy()
        hist_out[st.k % cfg.history] = [st.k, iters, loss_out, gradnorm, rho,
                                        st.delta, acc, endreason]
    return TRState(R_out, s_ex_out, loss_out, delta_out, shrink_out,
                   endreason, st.k + 1, total_inner, gradnorm, done,
                   done_reason, QsR_out, cc_out, accepts_out, hist_out)


def _run_chunk(Q, st: TRState, lam, gradtol, delta_bar, cfg: TRConfig,
               kmax: int, Q32=None) -> TRState:
    """Outer iterations until done or ``st.k >= kmax``."""
    qop = as_qop(Q)
    qmul = qop.apply
    Cdiag = qop.diag_blocks() if cfg.precondition else None
    qmul_inner = None
    if Q32 is not None:
        work_dtype = st.R.dtype
        q32 = as_qop(Q32)

        def qmul_inner(Y):
            return q32.apply(Y.to(torch.float32)).to(work_dtype)

    dt = np_dtype(st.R.dtype)
    lam, gradtol, delta_bar = dt(lam), dt(gradtol), dt(delta_bar)
    while not st.done and st.k < kmax:
        st = _outer_step(qmul, st, lam, gradtol, delta_bar, cfg, Cdiag,
                         qmul_inner)
    return st


def _init_state(Q, R0, s_ex0, lam, delta_bar, cfg: TRConfig,
                delta0=None) -> TRState:
    """Initial TR state.  ``delta0``: initial trust radius (default
    ``delta_bar / 8``, the reference's restart); a polish stage passes the
    previous phase's final radius."""
    dt = np_dtype(R0.dtype)
    qmul = as_qop(Q).apply
    sR0 = mf.flatten(mf.scale_blocks(R0, s_ex0))
    QsR0 = mf.unflatten(2.0 * qmul(sR0))
    s0 = s_ex0[1:]
    (loss0,) = _fetch(0.5 * mf.vdot(mf.flatten(QsR0), sR0)
                      + float(lam) * torch.sum((s0 * s0 - 1.0) ** 2), dt=dt)
    return TRState(
        R=R0, s_ex=s_ex0, loss=loss0, QsR=QsR0,
        delta=dt(delta_bar) / dt(8.0) if delta0 is None else dt(delta0),
        shrink_count=0, endreason=ER_MAX_INNER, k=0, total_inner=0,
        gradnorm=dt(np.inf), done=False, done_reason=RUNNING,
        collapse_count=0, accepts_since_collapse=0,
        # -1 in the k column marks never-written rows for print_history
        hist=(np.full((cfg.history, 8), -1.0, dt) if cfg.history else None),
    )


def _escape_linesearch(Q, R, s_ex, v_scaled, step0, lam, cfg: TRConfig):
    """Armijo-halving linesearch along the saddle-escape direction, placed in
    the last frame column, with a negative step.  Returns ``(R_new, f_new,
    ok)``; ``ok=False`` is the reference's "linesearch failed" abort."""
    qmul = as_qop(Q).apply
    dt = np_dtype(R.dtype)
    n, _, o = R.shape
    D = torch.zeros_like(R)
    D[:, :, o - 1] = v_scaled.reshape(n, 3)
    lam_f = float(lam)
    (f0,) = _fetch(mf.objective(qmul, R, s_ex, lam_f), dt=dt)

    def try_alpha(alpha):
        R_cand = mf.mgs_rows(R - float(alpha) * D)
        (f,) = _fetch(mf.objective(qmul, R_cand, s_ex, lam_f), dt=dt)
        return R_cand, f

    alpha, alpha_min = dt(step0), dt(cfg.linesearch_alpha_min)
    R_new, f = try_alpha(alpha)
    while f > f0 and alpha >= alpha_min:
        alpha = alpha / dt(2.0)
        R_new, f = try_alpha(alpha)
    ok = bool(f0 - f > 0.0) and bool(alpha >= alpha_min)
    return R_new, f, ok


def trust_region_solve(Q, R0, s_ex0, lam=0.0, gradtol=1e-6,
                       escape_dir=None, linesearch_step=0.0,
                       cfg: TRConfig = TRConfig(), dtype=None,
                       Q32=None, checkpoint_path: "str | None" = None,
                       ckpt_meta: "dict | None" = None,
                       verbose: int = 0, delta0=None,
                       device=None) -> TRResult:
    """Solve ``min <sR, Q sR> + lam sum((s^2-1)^2)`` over the product
    manifold (``xmtpu.solver.trust_region.trust_region_solve``).

    ``device``: None = the CUDA card (raises without one); pass ``"cpu"``
    to run on the host.  ``dtype``: working precision (default: R0's float
    type, else f64).
    """
    dev = resolve_device(device)
    if dtype is None:
        dtype = (R0.dtype if isinstance(R0, torch.Tensor)
                 else torch.float32 if np.asarray(R0).dtype == np.float32
                 else torch.float64)
        if dtype not in (torch.float32, torch.float64):
            dtype = torch.float64
    Q = as_qop(Q, device=dev)
    R0 = torch.as_tensor(R0, dtype=dtype, device=dev)
    s_ex0 = torch.as_tensor(s_ex0, dtype=dtype, device=dev)
    dt = np_dtype(dtype)
    n, _, o = R0.shape
    dim = n * (3 * o - 6) + n - 1
    delta_bar = dt(np.sqrt(float(dim)))

    R_cur, s_cur = R0, s_ex0
    if linesearch_step != 0.0 and escape_dir is not None:
        R_cur, _f, ok = _escape_linesearch(
            Q, R0, s_ex0, torch.as_tensor(escape_dir, dtype=dtype, device=dev),
            float(linesearch_step), lam, cfg)
        if not ok:
            return TRResult(R0, s_ex0, -1.0, float("inf"), 0, 0,
                            DONE_LINESEARCH_FAIL)

    st = _init_state(Q, R_cur, s_cur, dt(lam), delta_bar, cfg, delta0)

    Q32_inner = None
    if cfg.inner_f32 and dtype == torch.float64:
        if Q32 is not None:
            Q32_inner = Q32
        else:
            from xmtpu_torch.ops.qop import cast_qop

            Q32_inner = cast_qop(Q, torch.float32)

    deadline = time.monotonic() + cfg.max_time
    return continue_chunks(Q, st, lam, gradtol, delta_bar, cfg,
                           Q32=Q32_inner, k_done=0, deadline=deadline,
                           checkpoint_path=checkpoint_path,
                           ckpt_meta=ckpt_meta, verbose=verbose)


def continue_chunks(Q, st: TRState, lam, gradtol, delta_bar,
                    cfg: TRConfig, Q32=None, k_done: int = 0,
                    deadline: float = float("inf"),
                    checkpoint_path: "str | None" = None,
                    ckpt_meta: "dict | None" = None,
                    verbose: int = 0) -> TRResult:
    """Drive the chunked outer loop from an existing ``TRState`` until done,
    ``max_outer``, or the wall-clock deadline (checked between chunks);
    ``checkpoint_path`` saves the state after every unfinished chunk."""
    timed_out = False
    done = False
    while (not done) and k_done < cfg.max_outer:
        kmax = min(k_done + cfg.chunk, cfg.max_outer)
        k_prev = k_done
        st = _run_chunk(Q, st, lam, gradtol, delta_bar, cfg, kmax, Q32)
        k_done, done = st.k, st.done
        if verbose >= 2 and st.hist is not None and k_done > k_prev:
            print_history(st.hist, int(k_prev), int(k_done))
        if checkpoint_path is not None and not done:
            from xmtpu_torch.solver.checkpoint import save_tr_checkpoint

            save_tr_checkpoint(checkpoint_path, st, int(k_done),
                               **(ckpt_meta or {}))
        if done:
            break
        if time.monotonic() > deadline:
            timed_out = True
            break

    done_reason = st.done_reason
    if timed_out:
        done_reason = DONE_MAX_TIME
    elif not st.done:
        done_reason = DONE_MAX_OUTER
    return TRResult(st.R, st.s_ex, float(st.loss), float(st.gradnorm), st.k,
                    st.total_inner, done_reason, st.hist, st.delta)


def trust_region_solve_mixed(Q, R0, s_ex0, lam=0.0, gradtol=1e-6,
                             escape_dir=None, linesearch_step=0.0,
                             cfg: TRConfig = TRConfig(), Q32=None,
                             verbose: int = 0, device=None) -> TRResult:
    """Two-phase precision ladder: f32 bulk, f64 polish (see the reference).
    The f32 phase's tCG iterations run through the fused kernels on CUDA."""
    from xmtpu_torch.ops.qop import cast_qop

    dev = resolve_device(device)
    Q = as_qop(Q, device=dev)
    R0 = torch.as_tensor(R0, dtype=torch.float64, device=dev)
    s_ex0 = torch.as_tensor(s_ex0, dtype=torch.float64, device=dev)
    if linesearch_step != 0.0 and escape_dir is not None:
        res_ls = trust_region_solve(Q, R0, s_ex0, lam, gradtol,
                                    escape_dir=escape_dir,
                                    linesearch_step=linesearch_step,
                                    cfg=TRConfig(max_outer=0, chunk=1),
                                    device=dev)
        if res_ls.done_reason == DONE_LINESEARCH_FAIL:
            return res_ls
        R0, s_ex0 = res_ls.R, res_ls.s_ex

    cfg32, gradtol32 = cfg.f32_ladder(gradtol)
    if Q32 is None:
        Q32 = cast_qop(Q, torch.float32)
    res32 = trust_region_solve(Q32, R0.to(torch.float32),
                               s_ex0.to(torch.float32), lam, gradtol32,
                               cfg=cfg32, dtype=torch.float32,
                               verbose=verbose, device=dev)

    # f64 polish from the f32 iterate (re-orthonormalize in f64 first)
    R1 = mf.mgs_rows(res32.R.to(torch.float64))
    s1 = res32.s_ex.to(torch.float64).clone()
    s1[0] = 1.0
    res64 = trust_region_solve(Q, R1, s1, lam, gradtol, cfg=cfg, Q32=Q32,
                               verbose=verbose, device=dev)
    return TRResult(res64.R, res64.s_ex, res64.primal, res64.gradnorm,
                    res32.outer_iters + res64.outer_iters,
                    res32.total_inner + res64.total_inner,
                    res64.done_reason, res64.hist)
