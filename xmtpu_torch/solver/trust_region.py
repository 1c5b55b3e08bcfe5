"""Riemannian trust-region solver with truncated CG (RTR-tCG).

PyTorch counterpart of ``xmtpu/solver/trust_region.py``; see that module for
the reference semantics and line map.  The reference runs the outer and inner
loops as ``lax.while_loop``s inside one jitted program; here they are host
loops over device tensors.  Arrays (frames, scales, the carried ``2 Q sR``)
stay on the device; the outer loop's scalar control state (loss, trust
radius, counters, flags) lives on the host as numpy scalars of the working dtype, so every
scalar decision rounds exactly as the reference's device scalars do.

Inner-loop routing (``_inner_tcg``): an f32 carry on a CUDA device with the
block-Jacobi preconditioner goes through the fused kernels
(``ops.fused_tcg``).  Every other case runs the reference's loop on device
scalars (:func:`_tcg_open`, :func:`_tcg_body`: its IEEE operations in its
order, its branches as selects), eagerly with one host read an iteration;
where :func:`tcg_graph_route` holds (an f64 carry on a card, the
preconditioner on, the tCG's products on a ``capturable`` f32 operator
there: the ``inner_f32`` products on a whole fused ``SchurQ`` or an f32
``DenseQ``), ``EagerSegments.tcg`` replays the same loop as CUDA graphs
(``graph_step.InnerGraphs``), with one host read every ``FLAG_EVERY``
iterations.

One trust region, one ladder (:func:`_ladder`): the escape linesearch,
the mixed ladder's f32 phase and its handover to float64, then the stage;
``trust_region_solve``, ``trust_region_solve_mixed`` and each rank of
``solver/staircase.py`` run it.  It holds the one rule for the stage's
first radius: ``delta_bar / 8``, or the f32 phase's own where the caller
has a whole dense matrix and that phase ended within its first chunk.

One outer step (:func:`_outer_step`): its host reads, checks, spans and
decisions, around device segments from one of two providers.
:class:`EagerSegments` makes plain calls on the state's tensors; where
:func:`graph_route` holds (an f32 carry on a whole f32 ``DenseQ``, or a
whole ``SchurQ`` on the fused product, on one card, preconditioned),
``graph_step.PhaseGraphs`` replays CUDA graphs of the same segments on
static buffers, with the same bits.

Non-finite readings (:func:`_nonfinite`): an outer step in float32 whose
gradient norm, model decrease, trial loss or trust radius reads non-finite
at the step's host reads ends its phase at the last accepted iterate
(``DONE_NONFINITE``, counted in ``utils.timer.f32_nonfinite``); the mixed
ladder's f64 polish starts from there.  Every comparison of the step's
scalar logic is false on NaN, so without the check such a step would be
accepted.  The trial loss adds the scale penalty only where its weight is
non-zero: a trial scale past 2^32 squares twice to inf in float32, and
``0 * inf`` made the loss NaN where float64 reads it large and rejects the
step.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from xmtpu_torch._device import resolve_device
from xmtpu_torch.ops import fused_tcg
from xmtpu_torch.ops import manifold as mf
from xmtpu_torch.ops.qop import as_qop
from xmtpu_torch.utils.timer import f32_nonfinite, host_reads, span, spanned

# done_reason codes
RUNNING = 0
DONE_GRADTOL = 1        # gradnorm < gradtol
DONE_RDOTR_SMALL = 2    # tCG residual at machine precision (endreason 5)
DONE_LOSSQU = 3         # model decrease >= 0
DONE_DELTA = 4          # trust radius collapsed
DONE_MAX_OUTER = 5
DONE_MAX_TIME = 6
DONE_LINESEARCH_FAIL = 7  # staircase abort, primal = -1
DONE_NONFINITE = 8      # f32: a non-finite reading ended the phase

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
    one transfer (counted in ``utils.timer.host_reads``)."""
    host_reads.n += 1
    return tuple(dt(v) for v in torch.stack(xs).tolist())


def _precond(R, minv, rR, rs):
    """The block-Jacobi preconditioner ``minv = (minv_R, ms)``
    (:func:`_build_minv`) on a residual: the frames' tangent-projected
    block solve, the scales' diagonal one."""
    minv_R, ms = minv
    zR = mf.apply3(minv_R, rR)
    S = mf.sym3(mf.gram3(R, zR))
    return zR - mf.apply3(S, R), rs / ms


def _inner_tcg(qmul, R, s_ex, CsR, egR, egs, pgR, pgs, gradnorm, delta, lam,
               cfg: TRConfig, minv=None):
    """Steihaug truncated-CG on the trust-region subproblem (optionally
    block-Jacobi preconditioned: ``minv = (minv_R, ms)`` from
    :func:`_build_minv`).  Returns ``(vR, vs, hvR, hvs, endreason, iters)``
    with host ints for the last two.

    An f32 preconditioned carry on a card takes the fused kernels.  Every
    other case runs the loop on device scalars (:func:`_tcg_open`,
    :func:`_tcg_body`) eagerly, one iteration and one read of its flags at
    a time (``fused_tcg.until_done``), so that no iteration runs past the
    stop; on :func:`tcg_graph_route`'s route ``EagerSegments.tcg`` replays
    the same loop as CUDA graphs (``graph_step.InnerGraphs``)."""
    if (minv is not None and R.dtype == torch.float32
            and R.device.type == "cuda"):
        return fused_tcg.inner_tcg_fused(qmul, R, s_ex, CsR, egR, egs, pgR,
                                         pgs, gradnorm, delta, lam, cfg, minv)
    Segr, c = _tcg_open(R, s_ex, egR, pgR, pgs, minv)
    dd, thr = (torch.full((), float(v), dtype=R.dtype, device=R.device)
               for v in _tcg_limits(np_dtype(R.dtype), delta, gradnorm))
    zero = torch.zeros((), dtype=R.dtype, device=R.device)

    def advance():
        _tcg_body(qmul, R, s_ex, CsR, egR, egs, Segr, minv, float(lam), dd,
                  thr, zero, cfg, c)

    read = fused_tcg.until_done(advance, c.flags, cfg.max_inner,
                                at=(F_DONE, F_I))
    return c.vR, c.vs, c.hvR, c.hvs, int(read[F_ER]), int(read[F_I])


# the slots of TCGCarry.flags, what the host reads of the loop
F_DONE, F_I, F_ER = 0, 1, 2


class TCGCarry(NamedTuple):
    """The tCG loop's state on the device (:func:`_tcg_body`): the eight
    vectors, the five recurrence scalars as 0-d tensors of the working
    dtype, and the loop's control ``flags``, one int64 buffer of three:
    ``done`` (0 or 1), ``i`` (the iterations run) and ``er`` (the end
    reason), at :data:`F_DONE`, :data:`F_I` and :data:`F_ER`."""
    vR: torch.Tensor
    vs: torch.Tensor
    hvR: torch.Tensor
    hvs: torch.Tensor
    rR: torch.Tensor
    rs: torch.Tensor
    pR: torch.Tensor
    ps: torch.Tensor
    rdotr: torch.Tensor
    rdotz: torch.Tensor
    vdotv: torch.Tensor
    vdotp: torch.Tensor
    pdotp: torch.Tensor
    flags: torch.Tensor

    @property
    def done(self) -> torch.Tensor:
        return self.flags[F_DONE]

    @property
    def i(self) -> torch.Tensor:
        return self.flags[F_I]

    @property
    def er(self) -> torch.Tensor:
        return self.flags[F_ER]


def _tcg_limits(dt, delta, gradnorm):
    """The loop's two thresholds, rounded on the host in the numpy dtype
    ``dt`` as the reference rounds them: ``delta * delta`` and ``gradnorm *
    min(gradnorm, 0.1)``."""
    delta, gradnorm = dt(delta), dt(gradnorm)
    return delta * delta, gradnorm * np.minimum(gradnorm, dt(0.1))


def _tcg_open(R, s_ex, egR, pgR, pgs, minv) -> "tuple":
    """The tCG's preamble on the device, with nothing read back: ``(Segr,
    the first TCGCarry)``.  ``minv`` None: unpreconditioned (``z = r``)."""
    s = s_ex[1:]
    Segr = mf.sym3(mf.gram3(R, egR))
    rdotr = mf.inner(pgR, pgR, pgs, pgs, s)
    if minv is None:
        zR, zs, rdotz = pgR, pgs, rdotr.clone()
    else:
        zR, zs = _precond(R, minv, pgR, pgs)
        rdotz = mf.inner(pgR, zR, pgs, zs, s)
    zero = torch.zeros((), dtype=R.dtype, device=R.device)
    flags = torch.zeros((3,), dtype=torch.int64, device=R.device)
    flags[F_ER].fill_(ER_MAX_INNER)
    # no two fields share a tensor: _tcg_body writes them in place
    return Segr, TCGCarry(
        torch.zeros_like(pgR), torch.zeros_like(pgs), torch.zeros_like(pgR),
        torch.zeros_like(pgs), pgR.clone(), pgs.clone(), -zR, -zs, rdotr,
        rdotz, zero, zero.clone(), rdotz.clone(), flags)


def _tcg_body(qmul, R, s_ex, CsR, egR, egs, Segr, minv, lam_f: float, dd,
              thr, zero, cfg: TRConfig, c: TCGCarry) -> None:
    """One iteration of the Steihaug loop on the device, with nothing read
    back: the carry ``c`` advanced in place (on the graph route, a graph's
    static buffers).  ``dd`` and ``thr`` are :func:`_tcg_limits` and
    ``zero`` a 0.0, all 0-d tensors of the working dtype; ``minv`` None:
    unpreconditioned.

    The scalars round as the reference's device scalars do: each IEEE
    operation in its order, a branch a select (``torch.where``), with no
    fused multiply-add.  An iteration at or after the stop (``done``, or
    ``max_inner`` iterations run) leaves every carried value as it was, so
    a replay may run past the stop."""
    s = s_ex[1:]
    run = (c.done == 0) & (c.i < cfg.max_inner)
    rhR, rhs = mf.rhess(qmul, R, s_ex, CsR, egR, egs, c.pR, c.ps, lam_f,
                        Segr=Segr)
    pHp = mf.inner(c.pR, rhR, c.ps, rhs, s)
    alpha = c.rdotz / pHp
    small = c.rdotr < cfg.rdotr_min
    negcurv = (~small) & (alpha <= 0.0)
    boundary_q = c.vdotv + 2.0 * alpha * c.vdotp + alpha * alpha * c.pdotp
    exceed = (~small) & (~negcurv) & (boundary_q > dd)
    to_edge = negcurv | exceed
    normal = (~small) & (~to_edge)
    sqrt_val = torch.sqrt(torch.maximum(
        c.vdotp * c.vdotp + c.pdotp * (dd - c.vdotv), zero))
    tau = (-c.vdotp + sqrt_val) / c.pdotp

    coef = torch.where(to_edge, tau, torch.where(normal, alpha, zero))
    step_a = torch.where(normal, alpha, zero)
    rR = c.rR + step_a * rhR
    rs = c.rs + step_a * rhs
    zR, zs = (rR, rs) if minv is None else _precond(R, minv, rR, rs)
    rdotr_new = mf.inner(rR, rR, rs, rs, s)
    rdotz_new = (rdotr_new if minv is None
                 else mf.inner(rR, zR, rs, zs, s))
    superlin = normal & (torch.sqrt(rdotr_new) < thr)
    beta = rdotz_new / c.rdotz
    er = torch.where(small, ER_SMALL_RDOTR, torch.where(
        negcurv, ER_NEGCURV, torch.where(
            exceed, ER_BOUNDARY, torch.where(
                superlin, ER_SUPERLINEAR, ER_MAX_INNER))))
    upd = run & normal
    # every new value is made before a carried one is overwritten; the
    # vdotv update is boundary_q's expression
    new = ((c.vR + coef * c.pR, c.vR, run), (c.vs + coef * c.ps, c.vs, run),
           (c.hvR + coef * rhR, c.hvR, run), (c.hvs + coef * rhs, c.hvs, run),
           (rR, c.rR, run), (rs, c.rs, run),
           (-zR + beta * c.pR, c.pR, upd), (-zs + beta * c.ps, c.ps, upd),
           (rdotr_new, c.rdotr, upd), (rdotz_new, c.rdotz, upd),
           (boundary_q, c.vdotv, upd),
           (beta * (c.vdotp + alpha * c.pdotp), c.vdotp, upd),
           (beta * beta * c.pdotp + rdotz_new, c.pdotp, upd),
           (er, c.er, run))
    for value, carried, when in new:
        torch.where(when, value, carried, out=carried)
    c.done.logical_or_(run & (small | to_edge | superlin))
    c.i.add_(run)


def _build_minv(Cdiag, s_ex, lam):
    """Block-Jacobi preconditioner (see the reference's ``_build_minv``).
    Returns ``(minv (n,3,3), ms (n-1,))``: ``z_R = minv r_R`` (tangent-
    projected), ``z_s = r_s / ms``.  Device work only, with no read back
    (the graph route captures it): the Cholesky's ``info`` goes unread, as
    the reference's ``jnp.linalg.cholesky`` reports nothing either; the
    ``1e-4`` shift keeps each normalised block positive definite."""
    dtype, dev = Cdiag.dtype, Cdiag.device
    M = 2.0 * (s_ex * s_ex)[:, None, None] * Cdiag
    tr = torch.diagonal(M, dim1=-2, dim2=-1).sum(-1).mean() / 3.0
    tr = torch.maximum(tr, torch.full((), 1e-300, dtype=dtype, device=dev))
    M = M / tr
    eye = torch.eye(3, dtype=dtype, device=dev)
    M = M + 1e-4 * eye
    L, _info = torch.linalg.cholesky_ex(M)
    Linv = torch.linalg.solve_triangular(L, eye.expand(M.shape), upper=False,
                                         left=True)
    minv = torch.einsum("nka,nkb->nab", Linv, Linv)

    trC = torch.diagonal(Cdiag, dim1=-2, dim2=-1).sum(-1)[1:]
    s = s_ex[1:]
    ms_quad = 2.0 * trC
    ms = ms_quad + float(lam) * (12.0 * s * s - 4.0)
    ms = torch.maximum(ms, 0.2 * ms_quad) / tr
    ms = torch.maximum(ms, torch.full((), 1e-4, dtype=dtype, device=dev))
    # identity at lam == 0 (see the reference for the measurement)
    if not lam > 0:
        ms = torch.ones_like(ms)
    return minv, ms


def _step_start(qmul, R, s_ex, QsR, lam_f: float):
    """The outer step up to its tCG: the Euclidean gradient (from the
    carried ``QsR = 2 Q sR`` where there is one), its tangent projection and
    the norm.  Returns ``(CsR, egR, egs, pgR, pgs, gradnorm)``, the norm a
    0-d tensor.  Device work only: the graph route captures it."""
    s = s_ex[1:]
    if QsR is None:
        egR, egs, CsR = mf.egrad_csr(qmul, R, s_ex, lam_f)
    else:
        CsR = QsR
        egR, egs = mf.egrad_from_csr(CsR, R, s_ex, lam_f)
    pgR, pgs = mf.project(R, s, egR, egs)
    return CsR, egR, egs, pgR, pgs, torch.sqrt(mf.inner(pgR, pgR, pgs, pgs,
                                                         s))


def _step_end(qmul, R, s_ex, vR, vs, hvR, hvs, pgR, pgs, lam_f: float):
    """The outer step after its tCG: the model decrease, the retraction,
    the new carried ``2 Q sR`` and loss.  Returns ``(loss_qu, loss_new,
    R_new, s_ex_new, dfdsR_new)``, the losses 0-d tensors.  Device work
    only: the graph route captures it."""
    s = s_ex[1:]
    # <v, Hv>/2 + <v, g> folded into ONE metric reduction pass
    loss_qu = mf.inner(vR, 0.5 * hvR + pgR, vs, 0.5 * hvs + pgs, s)
    R_new, s_ex_new = mf.retract(R, s_ex, vR, vs, 1.0)
    sR_new = mf.flatten(mf.scale_blocks(R_new, s_ex_new))
    dfdsR_new = mf.unflatten(2.0 * qmul(sR_new))
    s_new = s_ex_new[1:]
    loss_new = 0.5 * mf.vdot(mf.flatten(dfdsR_new), sR_new)
    if lam_f:
        # a zero weight adds nothing: the penalty of a far trial scale is
        # inf in float32, and 0 * inf would make the loss NaN
        loss_new = loss_new + lam_f * torch.sum((s_new * s_new - 1.0) ** 2)
    return loss_qu, loss_new, R_new, s_ex_new, dfdsR_new


def _nonfinite(st: TRState, *readings) -> "TRState | None":
    """The state that ends a float32 phase at its last accepted iterate
    ``st`` where one of the host ``readings`` or the radius is not finite
    (counted in ``utils.timer.f32_nonfinite``); None otherwise, and always
    in float64."""
    if (st.R.dtype != torch.float32
            or np.isfinite(np.array(readings + (st.delta,))).all()):
        return None
    f32_nonfinite.n += 1
    return st._replace(done=True, done_reason=DONE_NONFINITE)


class EagerSegments:
    """The outer step's device segments as plain calls on the state's own
    tensors, with no copies: the provider :func:`_outer_step` takes
    everywhere but :func:`graph_route`'s route.  ``lam`` is the host scalar
    of the working dtype; ``Cdiag`` the operator's diagonal blocks for the
    block-Jacobi preconditioner (None: none); ``qmul_inner`` the tCG's
    product (default ``qmul``); ``inner`` the tCG's own provider on
    :func:`tcg_graph_route`'s route (``graph_step.InnerGraphs``: its
    ``solve`` returns what :func:`_inner_tcg` does), None for
    :func:`_inner_tcg`."""

    def __init__(self, qmul, lam, cfg: TRConfig, Cdiag=None, qmul_inner=None,
                 inner=None):
        self.qmul, self.lam, self.lam_f, self.cfg = qmul, lam, float(lam), cfg
        self.Cdiag = Cdiag
        self.qmul_inner = qmul if qmul_inner is None else qmul_inner
        self.inner = inner

    def state(self, st: TRState) -> TRState:
        return st

    def start(self, st: TRState):
        return _step_start(self.qmul, st.R, st.s_ex, st.QsR, self.lam_f)

    def tcg(self, st: TRState, grad, gradnorm):
        if self.inner is not None:
            return self.inner.solve(st, grad, gradnorm)
        minv = (None if self.Cdiag is None
                else _build_minv(self.Cdiag, st.s_ex, self.lam))
        return _inner_tcg(self.qmul_inner, st.R, st.s_ex, *grad[:5], gradnorm,
                          st.delta, self.lam, self.cfg, minv=minv)

    def end(self, st: TRState, grad, v):
        return _step_end(self.qmul, st.R, st.s_ex, *v, *grad[3:5], self.lam_f)

    def accept(self) -> None:
        pass

    def close(self) -> None:
        if self.inner is not None:
            self.inner.close()


def _outer_step(seg, st: TRState, gradtol, delta_bar) -> TRState:
    """One outer TR iteration: its host reads, checks, spans and decisions
    around the device segments of ``seg`` (:class:`EagerSegments`, or
    ``graph_step.PhaseGraphs`` on :func:`graph_route`'s route).  The
    segments: ``state`` (the state on the provider's tensors), ``start``
    (the gradient, its projection and norm: :func:`_step_start`'s six
    outputs), ``tcg`` (the tCG solve: ``(vR, vs, hvR, hvs, endreason,
    iters)``), ``end`` (:func:`_step_end`'s outputs, the kept tensors last)
    and ``accept`` (a kept step into the provider's tensors).  ``gradtol``
    and ``delta_bar`` are host scalars of the working dtype."""
    dt = np_dtype(st.R.dtype)
    st = seg.state(st)
    grad = seg.start(st)
    (gradnorm,) = _fetch(grad[5], dt=dt)
    end = _nonfinite(st, gradnorm)
    if end is not None:
        return end
    if gradnorm < gradtol:
        return st._replace(gradnorm=gradnorm, done=True,
                           done_reason=DONE_GRADTOL)

    with span("xm.tr.tcg"):
        *v, endreason, iters = seg.tcg(st, grad, gradnorm)
    loss_qu, loss_new, *kept = seg.end(st, grad, v)
    loss_qu, loss_new = _fetch(loss_qu, loss_new, dt=dt)
    end = _nonfinite(st, loss_qu, loss_new)
    if end is not None:
        return end
    keep_new, st = _step_decide(st, seg.cfg, delta_bar, gradnorm, endreason,
                                iters, loss_qu, loss_new, *kept)
    if keep_new:
        seg.accept()
    return st


def _step_decide(st: TRState, cfg: TRConfig, delta_bar, gradnorm, endreason,
                 iters, loss_qu, loss_new, R_new, s_ex_new,
                 dfdsR_new) -> "tuple[bool, TRState]":
    """The outer step's scalar logic on the host: ``rho``, the radius,
    acceptance, collapse and the stop rules.  Returns ``(keep_new, the next
    state)``; the next state holds ``R_new``, ``s_ex_new`` and ``dfdsR_new``
    where the step is kept."""
    dt = np_dtype(st.R.dtype)
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
    return keep_new, TRState(
        R_out, s_ex_out, loss_out, delta_out, shrink_out, endreason,
        st.k + 1, st.total_inner + iters, gradnorm, done, done_reason,
        QsR_out, cc_out, accepts_out, hist_out)


_CHUNK_SPAN = {torch.float32: "xm.tr.chunk.f32",
               torch.float64: "xm.tr.chunk.f64"}


def _run_chunk(Q, st: TRState, lam, gradtol, delta_bar, cfg: TRConfig,
               kmax: int, Q32=None) -> TRState:
    """Outer iterations until done or ``st.k >= kmax``, in the span
    ``xm.tr.chunk.f32`` or ``xm.tr.chunk.f64`` of the working dtype; their
    tCG products on ``Q32`` where it is given."""
    with span(_CHUNK_SPAN[st.R.dtype]):
        qop = as_qop(Q)
        dt = np_dtype(st.R.dtype)
        lam, gradtol, delta_bar = dt(lam), dt(gradtol), dt(delta_bar)
        if Q32 is None and graph_route(qop, st, cfg):
            from xmtpu_torch.solver.graph_step import PhaseGraphs

            seg = PhaseGraphs(qop, st, lam, cfg)
        else:
            qmul_inner = inner = None
            Cdiag = qop.diag_blocks() if cfg.precondition else None
            if Q32 is not None:
                work_dtype = st.R.dtype
                q32 = as_qop(Q32)

                def qmul_inner(Y):
                    return q32.apply(Y.to(torch.float32)).to(work_dtype)

                if Cdiag is not None and tcg_graph_route(q32, st, cfg):
                    from xmtpu_torch.solver.graph_step import InnerGraphs

                    inner = InnerGraphs(q32, qmul_inner, Cdiag, st, lam, cfg)
            seg = EagerSegments(qop.apply, lam, cfg, Cdiag, qmul_inner, inner)
        with contextlib.closing(seg):
            while not st.done and st.k < kmax:
                st = _outer_step(seg, st, gradtol, delta_bar)
    return st


def graph_route(qop, st: TRState, cfg: TRConfig) -> bool:
    """Whether a chunk's outer steps run as CUDA graphs
    (``solver/graph_step.py``): the carry is f32 with its ``2 Q sR`` on a
    CUDA device, the block-Jacobi preconditioner is on, and the operator's
    product is ``capturable`` there (a whole ``DenseQ`` in f32, or a whole
    ``SchurQ`` whose products take the fused kernels).  Every other case
    (``SchurQEdgeF32``, ``SchurQTF``, the sharded operators of
    ``parallel/``, f64 carries, every CPU run) steps through
    :class:`EagerSegments`."""
    R = st.R
    return (cfg.precondition and st.QsR is not None
            and R.dtype == torch.float32 and R.device.type == "cuda"
            and qop.capturable(R.device))


def tcg_graph_route(q32, st: TRState, cfg: TRConfig) -> bool:
    """Whether a chunk's tCG solves run on device scalars as CUDA graphs
    (``graph_step.InnerGraphs``, in ``EagerSegments.tcg``): the carry is
    f64 on a CUDA device, the block-Jacobi preconditioner is on, and the
    tCG's product ``q32`` (the f32 operator of ``inner_f32``) is
    ``capturable`` there (a whole ``DenseQ`` in f32, or a whole ``SchurQ``
    whose products take the fused kernels).  Every other case (CPU runs,
    unpreconditioned runs, f32 carries, f64 carries whose tCG product is
    the f64 operator itself, ``SchurQEdgeF32``, ``SchurQTF`` and the
    sharded operators as tCG products) runs the same loop eagerly in
    :func:`_inner_tcg`."""
    R = st.R
    return (cfg.precondition and R.dtype == torch.float64
            and R.device.type == "cuda" and q32.capturable(R.device))


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


@spanned("xm.tr.escape")
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
    manifold (``xmtpu.solver.trust_region.trust_region_solve``) through
    :func:`_ladder`'s single stage.

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
    if dtype != torch.float64:
        Q32 = None      # the f32 tCG products are for float64 carries
    elif cfg.inner_f32 and Q32 is None:
        from xmtpu_torch.ops.qop import cast_qop

        Q32 = cast_qop(Q, torch.float32)
    return _ladder(Q, R0, s_ex0, lam, gradtol, cfg, Q32,
                   escape_dir=escape_dir, step0=float(linesearch_step),
                   delta0=delta0, checkpoint_path=checkpoint_path,
                   ckpt_meta=ckpt_meta, verbose=verbose)


def continue_chunks(Q, st: TRState, lam, gradtol, delta_bar,
                    cfg: TRConfig, Q32=None, k_done: int = 0,
                    deadline: float = float("inf"),
                    checkpoint_path: "str | None" = None,
                    ckpt_meta: "dict | None" = None,
                    verbose: int = 0) -> TRResult:
    """Drive the chunked outer loop from an existing ``TRState`` until done,
    ``max_outer``, or the wall-clock deadline (checked between chunks);
    ``checkpoint_path`` saves the state after every unfinished chunk.  A
    state that is done already is its own result."""
    timed_out = False
    done = st.done
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
    """Two-phase precision ladder: f32 bulk, f64 polish (see the reference),
    through :func:`_ladder`; the polish starts at ``delta_bar / 8``, as the
    reference's does.  ``Q32``: the f32 operator (default: ``Q``'s cast).
    The f32 phase's tCG iterations run through the fused kernels on CUDA."""
    from xmtpu_torch.ops.qop import cast_qop

    dev = resolve_device(device)
    f64 = torch.float64
    Q = as_qop(Q, device=dev)
    R0 = torch.as_tensor(R0, dtype=f64, device=dev)
    s_ex0 = torch.as_tensor(s_ex0, dtype=f64, device=dev)
    if Q32 is None:
        Q32 = cast_qop(Q, torch.float32)
    return _ladder(Q, R0, s_ex0, lam, gradtol, cfg, Q32, mixed=True,
                   escape_dir=escape_dir, step0=float(linesearch_step),
                   verbose=verbose)


def _ladder(Q, R0, s_ex0, lam, gradtol, cfg: TRConfig, Q32=None, *,
            mixed: bool = False, warm: bool = False, escape_dir=None,
            step0: float = 1.0, delta0=None,
            checkpoint_path: "str | None" = None,
            ckpt_meta: "dict | None" = None, verbose: int = 0) -> TRResult:
    """The trust region from ``(R0, s_ex0)``, in order: the escape
    linesearch along ``escape_dir`` from the step ``step0`` on ``Q`` (none
    where either is None or zero);
    with ``mixed``, the f32 phase on ``Q32`` (:meth:`TRConfig.f32_ladder`)
    and its handover to float64; the stage on ``Q`` from the radius
    ``delta0`` (None: ``delta_bar / 8``), its tCG products on ``Q32`` where
    ``cfg.inner_f32``.  ``warm``: the operator is a whole dense matrix, and
    the stage may start from the f32 phase's radius (below).  One deadline,
    ``cfg.max_time`` from the start, checked between chunks;
    ``checkpoint_path`` saves the stage after every unfinished chunk.  The
    counts are both phases'; a failed linesearch returns ``R0`` with primal
    -1 (``DONE_LINESEARCH_FAIL``)."""
    deadline = time.monotonic() + cfg.max_time
    n, _, o = R0.shape
    delta_bar = np.sqrt(float(n * (3 * o - 6) + n - 1))
    if escape_dir is not None and step0:
        v = torch.as_tensor(escape_dir, dtype=R0.dtype, device=R0.device)
        R_ls, _f, ok = _escape_linesearch(Q, R0, s_ex0, v, step0, lam, cfg)
        if not ok:
            return TRResult(R0, s_ex0, -1.0, float("inf"), 0, 0,
                            DONE_LINESEARCH_FAIL)
        R0 = R_ls
    k32 = i32 = 0
    if mixed:
        f32, f64 = torch.float32, torch.float64
        cfg32, gradtol32 = cfg.f32_ladder(gradtol)
        st = _init_state(Q32, R0.to(f32), s_ex0.to(f32), np.float32(lam),
                         np.float32(delta_bar), cfg32)
        st = _run_chunk(Q32, st, lam, gradtol32, delta_bar, cfg32,
                        min(cfg32.chunk, cfg32.max_outer))
        if warm and st.done and np.isfinite(st.delta):
            # the stage's warm radius (xmtpu/solver/staircase.py:138-146):
            # the f32 phase's final radius, floored so that a hard f32
            # collapse cannot stall the f64 start.  The reference takes it
            # in its fused program alone: a dense operator, the f32 phase
            # ended within its first chunk.  Elsewhere delta_bar / 8
            delta0 = max(np.float64(st.delta), delta_bar * 1e-3)
        res32 = continue_chunks(Q32, st, lam, gradtol32, delta_bar, cfg32,
                                k_done=st.k, deadline=deadline,
                                verbose=verbose)
        # the handover: the f32 iterate re-orthonormalized in f64
        R0 = mf.mgs_rows(res32.R.to(f64))
        s_ex0 = res32.s_ex.to(f64).clone()
        s_ex0[0] = 1.0
        k32, i32 = res32.outer_iters, res32.total_inner
    st = _init_state(Q, R0, s_ex0, np_dtype(R0.dtype)(lam), delta_bar, cfg,
                     delta0)
    res = continue_chunks(Q, st, lam, gradtol, delta_bar, cfg,
                          Q32=Q32 if cfg.inner_f32 else None,
                          deadline=deadline, checkpoint_path=checkpoint_path,
                          ckpt_meta=ckpt_meta, verbose=verbose)
    return res._replace(outer_iters=res.outer_iters + k32,
                        total_inner=res.total_inner + i32)
