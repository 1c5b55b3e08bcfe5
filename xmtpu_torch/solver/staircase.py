"""Rank staircase: solve / solve_with_init / solve_rank3.

PyTorch counterpart of ``xmtpu/solver/staircase.py``, for dense cost
matrices and implicit operators (``ops/schurq.py``).  The staircase runs
the Riemannian trust region at rank o = 3, 4, ..., certifying each
solution with the dual certificate; on an uncertified
rank it grows the factor by one zero column and warm-starts an escape
linesearch along the certificate's minimum-eigenvalue direction divided
per camera by the scales.

Reference-faithful details kept here: ``gradtol /= 10`` whenever a rank
stops on the gradient norm; ``solve_with_init`` warm-starts only the scales;
status codes 1 = certified, 2 = max rank reached uncertified, -2 = escape
linesearch failed.  The mixed ladder's f32 phase runs at most one chunk
inside the stage (``kmax32``); when it outruns it, the stage falls back to
the unfused ladder exactly as the reference does, and the f64 polish starts
from the f32 phase's final trust radius (``delta0``).

Every dense rank takes the reference's CPU route on both devices: the stage
and its Cholesky-probe certificate run back to back (``fused_ok`` at all
sizes).  An implicit operator runs its stages through the unfused solvers,
on the two-float operator with ``edge_tf`` / ``edge_f32`` (stopping at the
first zero-accept collapse cycle, the final primal re-read through the
exact operator), and certifies through the matvec flow on the exact one.
So does a sharded dense operator (``parallel/``): it has no whole matrix
for the Cholesky probe, and its f32 cast is made slab by slab.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from xmtpu_torch._device import resolve_device
from xmtpu_torch.io.bin_format import load_matrix_from_bin, save_matrix_to_bin
from xmtpu_torch.ops import manifold as mf
from xmtpu_torch.solver import trust_region as tr
from xmtpu_torch.solver.certificate import certify
from xmtpu_torch.utils.timer import (applies_f32, applies_f64,
                                     applies_fused, applies_tf,
                                     f32_nonfinite, graph_replays,
                                     host_reads, max_memory_allocated,
                                     memory_allocated, span, spanned)

STATUS_CERTIFIED = 1
STATUS_MAX_RANK = 2
STATUS_LINESEARCH_FAIL = -2


def _scaled_factor(R, s_ex):
    return mf.flatten(mf.scale_blocks(R, s_ex))


class SolveResult(NamedTuple):
    R: np.ndarray        # (3n, o) flat factor, row-orthonormal 3x o blocks
    s_ex: np.ndarray     # (n,) extended scales, s_ex[0] == 1
    primal: float
    rank: int
    status: int
    certified: bool
    gap: float
    lam_min: float
    outer_iters: int
    total_inner: int
    # per-rank stage log: wall clock (stage_s solve, cert_s certificate:
    # the spans xm.stage and xm.cert enclose stage_s + cert_s and cert_s),
    # iteration counts, the certificate verdict, host_reads (the trust
    # region's device-to-host reads, utils.timer.host_reads), graph_replays
    # (the replays of its captured CUDA graphs, 0 on the eager route,
    # utils.timer.graph_replays), f32_nonfinite (the f32 phases ended at a
    # non-finite reading, utils.timer.f32_nonfinite), applies_f64,
    # applies_tf and applies_f32 (the implicit operator's products in the
    # rank, its certificate included: utils.timer's counters of those names),
    # applies_fused (those of the f32 products that ran as the fused
    # kernels, utils.timer.applies_fused) and, read only
    # while spans are on and on a card, mem_base_bytes (allocated at the
    # solve's start), peak_bytes and cert_peak_bytes (the card's peak
    # allocation at the end of the rank's trust region and of its
    # certificate)
    stages: tuple = ()


# a rank's counters in SolveResult.stages, by key (utils.timer)
_COUNTERS = {"host_reads": host_reads, "graph_replays": graph_replays,
             "f32_nonfinite": f32_nonfinite, "applies_f64": applies_f64,
             "applies_tf": applies_tf, "applies_f32": applies_f32,
             "applies_fused": applies_fused}


class _RankLog:
    """One rank's counters for ``SolveResult.stages`` (:data:`_COUNTERS`:
    the trust region's host reads, graph replays and non-finite f32 ends,
    the implicit operator's products), and while spans are on the card's
    memory (``mem_base`` is the solve's, None when not read)."""

    def __init__(self, dev, mem_base):
        self.dev = dev
        self.start = {k: c.n for k, c in _COUNTERS.items()}
        self.mem = {} if mem_base is None else {"mem_base_bytes": mem_base}

    def _peak(self, key):
        peak = max_memory_allocated(self.dev)
        if peak is not None:
            self.mem[key] = peak

    @contextlib.contextmanager
    def cert(self):
        """The span ``xm.cert``; the trust region ended where the rank's
        first certificate starts."""
        if "peak_bytes" not in self.mem:
            self._peak("peak_bytes")
        with span("xm.cert"):
            yield
        self._peak("cert_peak_bytes")

    def counters(self) -> dict:
        if "peak_bytes" not in self.mem:
            self._peak("peak_bytes")
        return dict({k: c.n - self.start[k] for k, c in _COUNTERS.items()},
                    **self.mem)


def _fail_state(R0, s_ex0) -> tr.TRState:
    """The state a failed escape linesearch leaves (primal = -1)."""
    return tr.TRState(
        R=R0, s_ex=s_ex0, loss=np.float64(-1.0), QsR=torch.zeros_like(R0),
        delta=np.float64(0.0), shrink_count=0, endreason=tr.ER_MAX_INNER,
        k=0, total_inner=0, gradnorm=np.float64(np.inf), done=True,
        done_reason=tr.DONE_LINESEARCH_FAIL)


def _stage_certify_fused(C, R0, s_ex0, lam, gradtol, gradtol32, delta_bar,
                         bound, cfg: tr.TRConfig, kmax: int, C32=None,
                         cfg32: Optional[tr.TRConfig] = None, kmax32: int = 0,
                         inner32: bool = False, with_cert: bool = True,
                         with_escape: bool = False, esc_v=None, step0=1.0,
                         *, log: _RankLog):
    """One rank: (escape linesearch ->) (f32 phase ->) f64 stage -> dense
    'auto' certificate, the certificate only when the stage finished inside
    ``kmax``.  Returns ``(st, st32, sR, Z, dual, psd, lam_min_est,
    lam_min_lb, v_inv, cert_s)`` with ``cert_s`` the certificate's wall
    seconds; ``st`` is None when the f32 phase outran ``kmax32`` (the
    caller then runs the unfused ladder)."""
    from xmtpu_torch.solver.certificate import _build_z_dual_psd

    ls_ok = True
    R_start = R0
    if with_escape:
        R_ls, _f, ls_ok = tr._escape_linesearch(C, R0, s_ex0, esc_v, step0,
                                                lam, cfg)
        R_start = R_ls if ls_ok else R0

    st32 = None
    if not ls_ok:
        st = _fail_state(R0, s_ex0)
        if cfg32 is not None:
            st32 = st
    else:
        R1, s1, delta0 = R_start, s_ex0, None
        if cfg32 is not None:
            f32 = torch.float32
            st32 = tr._init_state(C32, R_start.to(f32), s_ex0.to(f32),
                                  np.float32(lam), np.float32(delta_bar),
                                  cfg32)
            st32 = tr._run_chunk(C32, st32, lam, gradtol32, delta_bar,
                                 cfg32, kmax32)
            if not st32.done:
                return (None, st32) + (None,) * 7 + (0.0,)
            # f64 polish start: re-orthonormalize the f32 iterate in f64
            R1 = mf.mgs_rows(st32.R.to(torch.float64))
            s1 = st32.s_ex.to(torch.float64).clone()
            s1[0] = 1.0
            # polish warm-start radius: the f32 phase's final radius,
            # floored so a hard f32 collapse cannot stall the f64 start
            # (the default start where a non-finite radius ended the phase)
            delta0 = (max(np.float64(st32.delta), delta_bar * 1e-3)
                      if np.isfinite(st32.delta) else None)
        st = tr._init_state(C, R1, s1, lam, delta_bar, cfg, delta0)
        st = tr._run_chunk(C, st, lam, gradtol, delta_bar, cfg, kmax,
                           C32 if inner32 else None)
    sR = _scaled_factor(st.R, st.s_ex)
    if not with_cert or not (st.done and ls_ok):
        return (st, st32, sR) + (None,) * 6 + (0.0,)
    with log.cert():
        t0 = time.perf_counter()
        Z, dual, psd, lme, lmlb, v_inv = _build_z_dual_psd(C.C, sR, lam,
                                                           bound)
        cert_s = time.perf_counter() - t0
    return (st, st32, sR, Z, dual, psd, lme, lmlb, v_inv, cert_s)


def _stage_fused(Cq, C32q, R0, s_ex0, lam, gradtol, max_time, verbose,
                 precision: str, bound: float, v0,
                 inner_f32: bool = False, with_cert: bool = True,
                 escape_dir=None, linesearch_step: float = 0.0,
                 chunk: int = 100, checkpoint_path=None, ckpt_meta=None,
                 *, log: _RankLog):
    """Run one staircase rank through :func:`_stage_certify_fused`.
    Returns ``(res, scalars, cert, cert_s)``; ``cert`` is None when the
    stage did not finish inside its chunk (the caller certifies
    separately), else ``cert_s`` is its wall seconds."""
    from xmtpu_torch.solver import certificate as cert_mod

    n, _, o = R0.shape
    dim = n * (3 * o - 6) + n - 1
    delta_bar = float(np.sqrt(dim))
    cfg = tr.TRConfig(max_time=max_time, inner_f32=inner_f32, chunk=chunk,
                      history=chunk if int(verbose) >= 2 else 0)
    if precision == "mixed":
        cfg32, gradtol32 = cfg.f32_ladder(gradtol)
        kmax32 = cfg32.chunk
    else:
        cfg32, gradtol32, kmax32 = None, 0.0, 0

    with_escape = escape_dir is not None and linesearch_step != 0.0
    deadline = time.monotonic() + max_time  # stage wall budget incl. fused run
    st, st32, sR, Z, dual, psd, lme, lmlb, v_inv, cert_s = \
        _stage_certify_fused(
        Cq, R0, s_ex0, lam, gradtol, gradtol32, delta_bar, bound, cfg,
        cfg.chunk, C32q, cfg32, kmax32, inner32=inner_f32,
        with_cert=with_cert, with_escape=with_escape, esc_v=escape_dir,
        step0=float(linesearch_step), log=log)
    if st32 is not None:
        k32, i32, done32 = st32.k, st32.total_inner, st32.done
    else:
        k32, i32, done32 = 0, 0, True

    if st is not None and st.done_reason == tr.DONE_LINESEARCH_FAIL:
        # the reference's "linesearch failed! BM stopped!" (primal = -1)
        res = tr.TRResult(st.R, st.s_ex, float(st.loss), float(st.gradnorm),
                          st.k, st.total_inner, st.done_reason)
        return res, (-1.0, st.done_reason, 0, 0), None, 0.0

    if not done32:
        # the f32 phase outran its chunk: run it to its natural stall with
        # chunked continuation, then polish and certify separately (the
        # unfused ladder from here, as in the reference)
        res32 = tr.continue_chunks(C32q, st32, lam, gradtol32, delta_bar,
                                   cfg32, k_done=k32, deadline=deadline)
        R1 = mf.mgs_rows(res32.R.to(torch.float64))
        s1 = res32.s_ex.to(torch.float64).clone()
        s1[0] = 1.0
        res = tr.trust_region_solve(Cq, R1, s1, lam, gradtol, cfg=cfg,
                                    checkpoint_path=checkpoint_path,
                                    ckpt_meta=ckpt_meta,
                                    verbose=int(verbose), device=R1.device)
        outer_c = res.outer_iters + res32.outer_iters
        inner_c = res.total_inner + res32.total_inner
        if verbose:
            print(f"[xm] rank {o}: primal={res.primal:.6e} "
                  f"outer={outer_c} inner={inner_c} reason={res.done_reason}")
        return res, (res.primal, res.done_reason, outer_c, inner_c), None, 0.0

    if not st.done:
        # f64 stage outran its chunk: continue, the caller certifies
        if int(verbose) >= 2 and st.hist is not None:
            tr.print_history(st.hist, 0, st.k)
        res = tr.continue_chunks(Cq, st, lam, gradtol, delta_bar, cfg,
                                 Q32=C32q if inner_f32 else None,
                                 k_done=st.k, deadline=deadline,
                                 checkpoint_path=checkpoint_path,
                                 ckpt_meta=ckpt_meta, verbose=int(verbose))
        if verbose:
            print(f"[xm] rank {o}: primal={res.primal:.6e} "
                  f"outer={res.outer_iters + k32} "
                  f"inner={res.total_inner + i32} reason={res.done_reason}")
        scal = (res.primal, res.done_reason, res.outer_iters + k32,
                res.total_inner + i32)
        return res, scal, None, 0.0

    loss_v = float(st.loss)
    res = tr.TRResult(st.R, st.s_ex, loss_v, float(st.gradnorm), st.k,
                      st.total_inner, st.done_reason)
    if int(verbose) >= 2 and st.hist is not None:
        tr.print_history(st.hist, 0, st.k)
    if verbose:
        print(f"[xm] rank {o}: primal={loss_v:.6e} "
              f"gradnorm={float(st.gradnorm):.3e} outer={st.k + k32} "
              f"inner={st.total_inner + i32} reason={st.done_reason}")
    scal = (loss_v, st.done_reason, st.k + k32, st.total_inner + i32)
    if not with_cert:
        return res, scal, None, 0.0
    with log.cert():
        t0 = time.perf_counter()
        certified, v, lam_min, gap, dual_out = \
            cert_mod.finish_auto_certificate(Z, n, bound, loss_v, dual, psd,
                                             lme, lmlb, v_inv, v0=v0)
        cert_s += time.perf_counter() - t0
    if verbose:
        print(f"[certify] primal={loss_v:.6e} dual={dual_out:.6e} "
              f"gap={gap:.3e} lam_min={lam_min:.3e} "
              f"certified={bool(certified)}")
    cert = cert_mod.CertificateResult(bool(certified), v, lam_min, gap,
                                      dual_out, loss_v)
    return res, scal, cert, cert_s


def _stage(C, R0, s_ex0, lam, gradtol, max_time, escape_dir, verbose,
           precision: str = "f64", inner_f32: bool = False, Q32=None,
           checkpoint_path=None, ckpt_meta=None,
           stop_on_collapse: bool = False, chunk: Optional[int] = None):
    """One rank through the unfused solvers (no in-stage certificate)."""
    chunk_eff = chunk or tr.auto_chunk(R0.shape[0])
    cfg = tr.TRConfig(max_time=max_time, inner_f32=inner_f32,
                      chunk=chunk_eff, stop_on_collapse=stop_on_collapse,
                      history=chunk_eff if int(verbose) >= 2 else 0)
    kw = {"verbose": int(verbose), "device": R0.device}
    if precision == "mixed":
        solver = tr.trust_region_solve_mixed
    else:
        solver = tr.trust_region_solve
        kw.update(checkpoint_path=checkpoint_path, ckpt_meta=ckpt_meta)
    if escape_dir is None:
        res = solver(C, R0, s_ex0, lam, gradtol, cfg=cfg, Q32=Q32, **kw)
    else:
        res = solver(C, R0, s_ex0, lam, gradtol, escape_dir=escape_dir,
                     linesearch_step=1.0, cfg=cfg, Q32=Q32, **kw)
    if verbose:
        print(f"[xm] rank {R0.shape[2]}: primal={res.primal:.6e} "
              f"gradnorm={res.gradnorm:.3e} outer={res.outer_iters} "
              f"inner={res.total_inner} reason={res.done_reason}")
    return res


@spanned("xm.solve")
def solve_arrays(C, max_rank: int = 10, tol: float = 1e-6, lam: float = 0.0,
                 max_time: float = 1000.0, s0_ex: Optional[np.ndarray] = None,
                 rank3_only: bool = False, verbose: bool = True,
                 precision: str = "f64", inner_f32: bool = False,
                 edge_f32: bool = False, edge_tf: bool = False,
                 edge_pallas: Optional[bool] = None,
                 checkpoint_path: Optional[str] = None,
                 resume_from: Optional[str] = None,
                 chunk: Optional[int] = None, device=None) -> SolveResult:
    """In-memory staircase solve.

    Args:
      C: (3n, 3n) cost matrix (tensor, numpy array), ``DenseQ`` or an
        implicit operator (``SchurQ``; its tensors are moved to ``device``).
      s0_ex: optional (n,) initial extended scales (solve_rebuttle).
      rank3_only: single rank-3 TR solve, no certificate (solve_rank3).
      precision: "f64" (reference parity) or "mixed" (f32 bulk + f64 polish;
        certificates always run in f64).
      inner_f32: f32 tCG Hessian applies inside the f64 stages.
      edge_f32 / edge_tf: implicit operators only — run the TR stages on the
        mixed (``SchurQ.edge_f32``) or fully two-float (``SchurQ.two_float``,
        takes precedence) operator; the certificate and the final primal
        stay on the exact one.
      edge_pallas: with those, record the reference kernel's segment-sum
        bands on the fast operator (``SchurQ.edge_f32``); its segment sums
        take the CUDA kernel on the card whatever it is.
      checkpoint_path / resume_from: staircase checkpoints (``.npz``).
      chunk: outer iterations between host checks (None = auto_chunk(n)).
      device: None = the CUDA card (raises without one); ``"cpu"`` for the
        host.
    """
    from xmtpu_torch.ops.qop import DenseQ, as_qop, cast_qop
    from xmtpu_torch.solver.certificate import _min_eig_bound
    from xmtpu_torch.solver.checkpoint import (StaircaseCheckpoint,
                                               TRCheckpoint, load_checkpoint,
                                               save_checkpoint,
                                               tr_state_from_checkpoint)

    dev = resolve_device(device)
    mem_base = memory_allocated(dev)
    Cq = as_qop(C, device=dev)
    dense = isinstance(Cq, DenseQ)
    if dense and Cq.C.dtype != torch.float64:
        Cq = DenseQ(Cq.C.to(torch.float64), Cq.psd_hint)
    n = Cq.dim // 3
    want32 = precision == "mixed" or inner_f32
    # a dense matrix, whole or in row slabs (its f32 cast made slab by slab)
    rows = Cq.dense_rows
    C32q = cast_qop(Cq, torch.float32) if rows and want32 else None
    stage_q, stage_q32 = Cq, None
    if edge_tf and not rows:
        stage_q = Cq.two_float(pallas=edge_pallas)
    elif edge_f32 and not rows:
        stage_q = Cq.edge_f32(pallas=edge_pallas)
    if stage_q is not Cq and want32:
        # inner tCG / f32 phase cast from the BASE operator: single product
        # terms, no hi/lo double work
        stage_q32 = cast_qop(Cq, torch.float32)
    bound = _min_eig_bound(n)
    gradtol = float(tol)
    chunk_n = chunk if chunk is not None else tr.auto_chunk(n)
    f64 = torch.float64

    o = 3
    R0 = mf.identity_frames(n, 3, dtype=f64, device=dev)
    s_ex = (torch.as_tensor(np.array(s0_ex, np.float64), device=dev)
            if s0_ex is not None
            else torch.ones((n,), dtype=f64, device=dev))
    escape_dir = None
    prev_escape_v = None

    mid_resume = None   # TRCheckpoint: resume inside a rank
    if resume_from is not None:
        ck = load_checkpoint(resume_from)
        o, gradtol = ck.rank, ck.gradtol
        if isinstance(ck, TRCheckpoint):
            mid_resume = ck
        else:
            R0 = torch.as_tensor(ck.R, dtype=f64, device=dev)
            s_ex = torch.as_tensor(ck.s_ex, dtype=f64, device=dev)
            escape_dir = (torch.as_tensor(ck.escape_dir, dtype=f64,
                                          device=dev)
                          if ck.escape_dir is not None else None)

    R_cur, s_cur = R0, s_ex
    primal = float("nan")
    status = STATUS_MAX_RANK
    certified = False
    gap = float("nan")
    lam_min = float("nan")
    outer = inner = 0

    mid_path = (checkpoint_path + ".mid" if checkpoint_path is not None
                else None)
    stages = []
    while o <= max_rank:
        with span("xm.stage"):
            # one rank, from the clock of stage_s through its certificate
            t_stage0 = time.perf_counter()
            log = _RankLog(dev, mem_base)
            fused_ok = dense and precision in ("f64", "mixed")
            cert_pre, cert_s = None, 0.0
            meta = dict(rank=o, gradtol=gradtol, lam=float(lam))
            if mid_resume is not None:
                # finish the interrupted rank from its chunk-boundary state
                st = tr_state_from_checkpoint(mid_resume, Q=stage_q,
                                              device=dev)
                dim = n * (3 * o - 6) + n - 1
                delta_bar = float(np.sqrt(dim))
                cfg = tr.TRConfig(max_time=max_time, inner_f32=inner_f32,
                                  chunk=chunk_n)
                res = tr.continue_chunks(
                    stage_q, st, mid_resume.lam, gradtol, delta_bar, cfg,
                    Q32=(C32q if rows else stage_q32) if inner_f32 else None,
                    k_done=mid_resume.k_done,
                    deadline=time.monotonic() + max_time,
                    checkpoint_path=mid_path, ckpt_meta=meta)
                primal_v, reason_v = res.primal, res.done_reason
                outer_v, inner_v = res.outer_iters, res.total_inner
                if verbose:
                    print(f"[xm] rank {o} (resumed at outer "
                          f"{mid_resume.k_done}): primal={primal_v:.6e}")
                mid_resume = None
            elif fused_ok:
                res, scal, cert_pre, cert_s = _stage_fused(
                    Cq, C32q, R0, s_ex, lam, gradtol, max_time, verbose,
                    precision, bound, prev_escape_v, inner_f32=inner_f32,
                    with_cert=not rank3_only, escape_dir=escape_dir,
                    linesearch_step=(1.0 if escape_dir is not None else 0.0),
                    chunk=chunk_n, checkpoint_path=mid_path, ckpt_meta=meta,
                    log=log)
                primal_v, reason_v, outer_v, inner_v = scal
            else:
                res = _stage(stage_q, R0, s_ex, lam, gradtol, max_time,
                             escape_dir, verbose, precision, inner_f32,
                             Q32=C32q if rows else stage_q32,
                             checkpoint_path=mid_path, ckpt_meta=meta,
                             stop_on_collapse=stage_q is not Cq, chunk=chunk_n)
                if (stage_q is not Cq
                        and res.done_reason != tr.DONE_LINESEARCH_FAIL):
                    # the fast operator's absolute noise (~eta ||sR||^2) shows
                    # against a near-zero primal (it can even read negative):
                    # re-read the objective through the EXACT operator.  Only
                    # the linesearch-fail sentinel keeps the stage's primal
                    # (guarded by done_reason, not by sign)
                    res = res._replace(primal=float(mf.objective(
                        Cq.apply, res.R, res.s_ex, float(lam))))
                primal_v, reason_v = res.primal, res.done_reason
                outer_v, inner_v = res.outer_iters, res.total_inner
            outer += int(outer_v)
            inner += int(inner_v)
            # the stage call's own certificate is reported under cert_s
            t_stage = time.perf_counter() - t_stage0 - cert_s

            if (float(primal_v) < 0
                    and int(reason_v) == tr.DONE_LINESEARCH_FAIL):
                status = STATUS_LINESEARCH_FAIL
                stages.append(dict(rank=o, stage_s=t_stage, cert_s=0.0,
                                   outer=int(outer_v), inner=int(inner_v),
                                   reason=int(reason_v),
                                   primal=float(primal_v), certified=False,
                                   **log.counters()))
                break

            R_cur, s_cur, primal = res.R, res.s_ex, float(primal_v)
            if int(reason_v) == tr.DONE_GRADTOL:
                gradtol /= 10.0  # the reference's pass-by-reference tolerance

            if rank3_only:
                status = STATUS_MAX_RANK
                stages.append(dict(rank=o, stage_s=t_stage, cert_s=0.0,
                                   outer=int(outer_v), inner=int(inner_v),
                                   reason=int(reason_v),
                                   primal=float(primal_v), certified=False,
                                   **log.counters()))
                break

            if cert_pre is not None:
                cert = cert_pre   # the stage ran the certificate (fused=True)
            else:
                with log.cert():
                    t_cert0 = time.perf_counter()
                    cert = certify(Cq, _scaled_factor(R_cur, s_cur), lam,
                                   res.primal, verbose=verbose,
                                   v0=prev_escape_v, fast="auto", device=dev)
                    cert_s = time.perf_counter() - t_cert0
            gap, lam_min = float(cert.gap), float(cert.lam_min)
            stages.append(dict(
                rank=o, stage_s=t_stage, cert_s=cert_s,
                fused=cert_pre is not None,
                # the deciding branch of the matvec flow; "dense" for the
                # Cholesky probe on the whole matrix
                cert_path=(cert.info or {}).get("path", "dense"),
                outer=int(outer_v),
                inner=int(inner_v), reason=int(reason_v),
                primal=float(primal_v), certified=bool(cert.certified),
                gap=gap, lam_min=lam_min, **log.counters()))

        if cert.certified:
            status = STATUS_CERTIFIED
            certified = True
            break
        if o < max_rank:
            # grow one zero column, warm-start escape direction v / s
            R0 = torch.cat([R_cur, torch.zeros((n, 3, 1), dtype=R_cur.dtype,
                                               device=dev)], dim=2)
            s_ex = s_cur
            prev_escape_v = cert.v
            escape_dir = (cert.v.reshape(n, 3) / s_cur[:, None]).reshape(3 * n)
            o += 1
            if checkpoint_path is not None:
                save_checkpoint(checkpoint_path, StaircaseCheckpoint(
                    R=R0.cpu().numpy(), s_ex=s_ex.cpu().numpy(), rank=o,
                    gradtol=gradtol, escape_dir=escape_dir.cpu().numpy(),
                    lam=float(lam)))
        else:
            status = STATUS_MAX_RANK
            break

    R_host = R_cur.cpu().numpy()
    return SolveResult(
        R=R_host.reshape(-1, R_host.shape[-1]),
        s_ex=s_cur.cpu().numpy(),
        primal=primal,
        rank=R_cur.shape[2],
        status=status,
        certified=certified,
        gap=gap,
        lam_min=lam_min,
        outer_iters=outer,
        total_inner=inner,
        stages=tuple(stages),
    )


def _save_result(dataset_path: str, result: SolveResult) -> None:
    """Write R.bin / s.bin in the reference format."""
    save_matrix_to_bin(os.path.join(dataset_path, "R.bin"), result.R)
    save_matrix_to_bin(os.path.join(dataset_path, "s.bin"),
                       result.s_ex.reshape(-1, 1))


def solve(dataset_path: str, max_rank: int = 10, tol: float = 1e-6,
          lam: float = 0.0, max_time: float = 1000.0,
          verbose: bool = True, device=None) -> SolveResult:
    """File-based staircase solve: reads ``Q.bin``, writes
    ``R.bin``/``s.bin``."""
    C, _ = load_matrix_from_bin(os.path.join(dataset_path, "Q.bin"))
    result = solve_arrays(C, max_rank, tol, lam, max_time, verbose=verbose,
                          device=device)
    _save_result(dataset_path, result)
    return result


def solve_with_init(dataset_path: str, max_rank: int = 10, tol: float = 1e-6,
                    lam: float = 0.0, max_time: float = 1000.0,
                    verbose: bool = True, device=None) -> int:
    """Warm-started solve (reference ``solve_rebuttle``): reads
    ``s_ini.bin``; only the scales survive into the o=3 stage.  Returns the
    status code."""
    C, _ = load_matrix_from_bin(os.path.join(dataset_path, "Q.bin"))
    s_ini, _ = load_matrix_from_bin(os.path.join(dataset_path, "s_ini.bin"))
    result = solve_arrays(C, max_rank, tol, lam, max_time,
                          s0_ex=np.asarray(s_ini).ravel(), verbose=verbose,
                          device=device)
    _save_result(dataset_path, result)
    return result.status


def solve_rank3(dataset_path: str, max_rank: int = 10, tol: float = 1e-6,
                lam: float = 0.0, max_time: float = 1000.0,
                verbose: bool = True, device=None) -> SolveResult:
    """Single rank-3 TR solve, no certificate."""
    C, _ = load_matrix_from_bin(os.path.join(dataset_path, "Q.bin"))
    result = solve_arrays(C, max_rank, tol, lam, max_time, rank3_only=True,
                          verbose=verbose, device=device)
    _save_result(dataset_path, result)
    return result
