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
linesearch failed.

Every rank takes one path, :func:`_rank`, on three operators that
``solve_arrays`` chooses once: the exact one, the stage's and the f32 cast
of the exact one.  The reference fuses a dense rank's stage and its
certificate into one device program; here the loop runs on the host, so a
rank is its steps in order: the escape linesearch, the mixed ladder's f32
phase, the f64 stage (``trust_region._ladder``, which also holds the rule
for the stage's first radius), the exact re-read of the primal after a
fast stage, and the certificate (``certificate.certify``: the Cholesky
probe on a whole dense matrix, the matvec flow on the rest).  An implicit
operator's stages run on its two-float form with ``edge_tf`` or its
mixed-edge form with ``edge_f32``, stopping at the first zero-accept
collapse cycle; a sharded dense operator (``parallel/``) has no whole
matrix for the Cholesky probe, and its f32 cast is made slab by slab.
"""


from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from xmtpu_torch._device import resolve_device
from xmtpu_torch.io.bin_format import load_matrix_from_bin, save_matrix_to_bin
from xmtpu_torch.ops import manifold as mf
from xmtpu_torch.solver import trust_region as tr
from xmtpu_torch.solver.certificate import CertificateResult, certify
from xmtpu_torch.utils.timer import (applies_f32, applies_f64,
                                     applies_fused, applies_replayed,
                                     applies_tf,
                                     f32_nonfinite, graph_replays,
                                     host_reads, inner_masked, inner_replayed,
                                     max_memory_allocated,
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
    # kernels, utils.timer.applies_fused), applies_replayed (the products
    # that ran by graph replay, utils.timer.applies_replayed), inner_replayed
    # and inner_masked (the f64 tCG's inner iterations that ran inside a
    # replayed loop graph, and those a replay ran past the loop's stop:
    # utils.timer's counters of those names) and, read only
    # while spans are on and on a card, mem_base_bytes (allocated at the
    # solve's start), peak_bytes and cert_peak_bytes (the card's peak
    # allocation at the end of the rank's trust region and of its
    # certificate)
    stages: tuple = ()


# a rank's counters in SolveResult.stages, by key (utils.timer)
_COUNTERS = {"host_reads": host_reads, "graph_replays": graph_replays,
             "f32_nonfinite": f32_nonfinite, "applies_f64": applies_f64,
             "applies_tf": applies_tf, "applies_f32": applies_f32,
             "applies_fused": applies_fused,
             "applies_replayed": applies_replayed,
             "inner_replayed": inner_replayed, "inner_masked": inner_masked}


class _RankLog:
    """One rank's counters for ``SolveResult.stages`` (:data:`_COUNTERS`:
    the trust region's host reads, graph replays and non-finite f32 ends,
    the implicit operator's products, the replayed and masked f64 inner
    iterations), and while spans are on the card's
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
        """The span ``xm.cert``; the trust region ended where it starts."""
        self._peak("peak_bytes")
        with span("xm.cert"):
            yield
        self._peak("cert_peak_bytes")

    def counters(self) -> dict:
        if "peak_bytes" not in self.mem:
            self._peak("peak_bytes")
        return dict({k: c.n - self.start[k] for k, c in _COUNTERS.items()},
                    **self.mem)


class _Rank(NamedTuple):
    """One rank's outcome: the trust region over both phases (its primal
    re-read through the exact operator after a fast stage), the
    certificate (None where none ran) and its wall seconds."""
    res: tr.TRResult
    cert: Optional[CertificateResult]
    cert_s: float


def _rank(Cq, stage_q, q32, R0, s_ex0, lam, gradtol, cfg: tr.TRConfig, *,
          mixed: bool, escape_dir, v0, with_cert: bool, resume,
          checkpoint_path, ckpt_meta, verbose, log: _RankLog) -> _Rank:
    """One rank of the staircase, on every route: the escape linesearch
    along ``escape_dir`` on the stage operator ``stage_q``, with ``mixed``
    the f32 phase on ``q32``, the f64 stage on ``stage_q``
    (``trust_region._ladder``); the primal re-read through the exact
    ``Cq`` where the stage's operator is a fast one; then, ``with_cert``
    and unless the linesearch failed, the certificate on ``Cq``.
    ``resume``: a ``TRCheckpoint`` inside this rank, whose f64 stage is
    continued instead, as the reference does (with neither the collapse
    stop nor the re-read)."""
    from xmtpu_torch.ops.qop import DenseQ
    from xmtpu_torch.solver.checkpoint import tr_state_from_checkpoint

    dev = R0.device
    if resume is not None:
        st = tr_state_from_checkpoint(resume, Q=stage_q, device=dev)
        n, _, o = st.R.shape
        res = tr.continue_chunks(
            stage_q, st, resume.lam, gradtol,
            float(np.sqrt(n * (3 * o - 6) + n - 1)),
            dataclasses.replace(cfg, stop_on_collapse=False, history=0),
            Q32=q32 if cfg.inner_f32 else None, k_done=resume.k_done,
            deadline=time.monotonic() + cfg.max_time,
            checkpoint_path=checkpoint_path, ckpt_meta=ckpt_meta)
    else:
        res = tr._ladder(stage_q, R0, s_ex0, lam, gradtol, cfg, q32,
                         mixed=mixed, warm=isinstance(Cq, DenseQ),
                         escape_dir=escape_dir,
                         checkpoint_path=checkpoint_path,
                         ckpt_meta=ckpt_meta, verbose=int(verbose))
        if (stage_q is not Cq
                and res.done_reason != tr.DONE_LINESEARCH_FAIL):
            # the fast operator's absolute noise (~eta ||sR||^2) shows
            # against a near-zero primal (it can even read negative):
            # re-read the objective through the EXACT operator.  The
            # linesearch-fail sentinel keeps its -1
            res = res._replace(primal=float(mf.objective(
                Cq.apply, res.R, res.s_ex, float(lam))))
    if verbose:
        print(f"[xm] rank {res.R.shape[2]}: primal={res.primal:.6e} "
              f"gradnorm={res.gradnorm:.3e} outer={res.outer_iters} "
              f"inner={res.total_inner} reason={res.done_reason}")
    if not with_cert or res.done_reason == tr.DONE_LINESEARCH_FAIL:
        return _Rank(res, None, 0.0)
    with log.cert():
        t0 = time.perf_counter()
        cert = certify(Cq, _scaled_factor(res.R, res.s_ex), lam, res.primal,
                       verbose=verbose, v0=v0, fast="auto", device=dev)
        cert_s = time.perf_counter() - t0
    return _Rank(res, cert, cert_s)


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
    from xmtpu_torch.solver.checkpoint import (StaircaseCheckpoint,
                                               TRCheckpoint, load_checkpoint,
                                               save_checkpoint)

    dev = resolve_device(device)
    mem_base = memory_allocated(dev)
    Cq = as_qop(C, device=dev)
    if isinstance(Cq, DenseQ) and Cq.C.dtype != torch.float64:
        Cq = DenseQ(Cq.C.to(torch.float64), Cq.psd_hint)
    n = Cq.dim // 3
    # the rank's operators, chosen once: the exact one (the certificate,
    # the final primal); the stage's, a fast form of an implicit operator
    # where one is asked for; the exact one's f32 cast for the f32 phase
    # and the f32 tCG products (single product terms, no hi/lo double
    # work; a dense matrix in row slabs is cast slab by slab)
    stage_q = Cq
    if edge_tf and not Cq.dense_rows:
        stage_q = Cq.two_float(pallas=edge_pallas)
    elif edge_f32 and not Cq.dense_rows:
        stage_q = Cq.edge_f32(pallas=edge_pallas)
    mixed = precision == "mixed"
    q32 = cast_qop(Cq, torch.float32) if mixed or inner_f32 else None
    chunk_n = chunk if chunk is not None else tr.auto_chunk(n)
    # a fast operator's f64 stage stops at its first zero-accept collapse
    # cycle (its noise floor), as every f32 phase does
    cfg = tr.TRConfig(max_time=max_time, inner_f32=inner_f32, chunk=chunk_n,
                      stop_on_collapse=stage_q is not Cq,
                      history=chunk_n if int(verbose) >= 2 else 0)
    gradtol = float(tol)
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
            res, cert, cert_s = _rank(
                Cq, stage_q, q32, R0, s_ex, lam, gradtol, cfg, mixed=mixed,
                escape_dir=escape_dir, v0=prev_escape_v,
                with_cert=not rank3_only, resume=mid_resume,
                checkpoint_path=mid_path,
                ckpt_meta=dict(rank=o, gradtol=gradtol, lam=float(lam)),
                verbose=verbose, log=log)
            mid_resume = None
            outer += int(res.outer_iters)
            inner += int(res.total_inner)
            # the rank's certificate is reported under cert_s
            stage = dict(rank=o, stage_s=time.perf_counter() - t_stage0
                         - cert_s, cert_s=cert_s, outer=int(res.outer_iters),
                         inner=int(res.total_inner),
                         reason=int(res.done_reason),
                         primal=float(res.primal), certified=False)
            if cert is not None:
                gap, lam_min = float(cert.gap), float(cert.lam_min)
                # the deciding branch of the matvec flow; "dense" for the
                # Cholesky probe on the whole matrix
                stage.update(cert_path=(cert.info or {}).get("path",
                                                              "dense"),
                             certified=bool(cert.certified), gap=gap,
                             lam_min=lam_min)
            stages.append(dict(stage, **log.counters()))

        if res.done_reason == tr.DONE_LINESEARCH_FAIL:
            status = STATUS_LINESEARCH_FAIL
            break
        R_cur, s_cur, primal = res.R, res.s_ex, float(res.primal)
        if res.done_reason == tr.DONE_GRADTOL:
            gradtol /= 10.0  # the reference's pass-by-reference tolerance
        if rank3_only:
            status = STATUS_MAX_RANK
            break
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
