"""Q-matrix assembly: build the SBA cost ``C`` and recovery operator ``Abar``.

PyTorch counterpart of ``xmtpu/assembly/creatematrix.py`` (same math, same
line-by-line structure; see that module for the reference line map).
Translations and landmark positions are eliminated in closed form (anchored
Schur complement + Sherman-Morrison rank-1 anchor correction), producing the
dense PSD cost matrix ``C`` and the recovery operator ``Abar``.

The per-frame and per-landmark reductions (``q2``, ``Q1``, ``V1`` by
frame, ``q3`` by landmark) run through the hand-written
``sorted_segment_sum`` (:class:`~xmtpu_torch.ops.segsum.Segments`, layouts
``assembly frame`` and ``assembly landmark``), built once per assembly from
the host ids: each segment's rows are added in edge order, the order of
``index_add_`` on the host, so on the card C has the same bits on every
run.  ``V3`` and ``V2`` are put at their (frame, landmark) positions
without accumulation; where a pair repeats, its rows are first summed by
pair the same way (``assembly pair``).  The (N+M)x(N+M)
translation/landmark block is applied implicitly.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from xmtpu_torch._device import resolve_device
from xmtpu_torch.io.bin_format import save_matrix_to_bin
from xmtpu_torch.ops.segsum import Segments


def _cholesky_or_nan(A: torch.Tensor) -> torch.Tensor:
    """Cholesky factor of ``A``, NaN-filled on breakdown (the reference's
    ``cho_factor`` semantics, which the f32 assembly's fallback tests)."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where(info.reshape(info.shape + (1, 1)) == 0, L,
                       torch.full_like(L, float("nan")))


class _EdgeSums(NamedTuple):
    """The assembly's segment sums over the E edges, built once from the
    host ids: by ``frame`` (N segments) and by ``landmark`` (M); by
    ``pair`` (one segment for each distinct (frame, landmark) pair, in the
    order of ``f * M + l``) where a pair repeats, else None; and ``at``,
    the (frame, landmark) positions of the summed rows of V3 and V2."""

    frame: Segments
    landmark: Segments
    pair: Optional[Segments]
    at: "tuple[torch.Tensor, torch.Tensor]"


def _edge_sums(f: np.ndarray, l: np.ndarray, N: int, M: int,
               device) -> _EdgeSums:
    """:class:`_EdgeSums` of the 0-based host ids ``f``/``l`` (E,) on
    ``device``; reads nothing from the device."""
    f = np.asarray(f, dtype=np.int64)
    l = np.asarray(l, dtype=np.int64)
    flat = f * M + l
    # the pairs present, on a map of N * M bytes (V2 takes 24 N M on the
    # device): a repeat leaves fewer pairs than edges
    seen = np.zeros(N * M, dtype=bool)
    seen[flat] = True
    if np.count_nonzero(seen) == len(flat):
        pair, pf, pl = None, f, l
    else:
        pairs, of_edge = np.unique(flat, return_inverse=True)
        pair = Segments(of_edge.ravel(), len(pairs), device, "assembly pair")
        pf, pl = pairs // M, pairs % M
    return _EdgeSums(Segments(f, N, device, "assembly frame"),
                     Segments(l, M, device, "assembly landmark"), pair,
                     (torch.as_tensor(pf, device=device),
                      torch.as_tensor(pl, device=device)))


def _assemble(w, x, sums: _EdgeSums, N: int, M: int, dtype=torch.float64):
    """Core assembly.  w:(E,) weights, x:(E,3) lifted landmark
    observations, on the device of ``sums`` (:func:`_edge_sums` of the
    edges' frame and landmark ids).

    ``dtype=torch.float32`` runs the heavy middle in f32 (~1e-6 relative C
    error).  Outputs are float64 either way."""
    dev = w.device
    w = w.to(dtype)
    x = x.to(dtype)
    E = w.shape[0]

    wx = w[:, None] * x                                            # (E,3)
    # the frame sums in one launch: [w | wx | wx x^T] -> [q2 | V1 | Q1]
    by_frame = sums.frame.sum(torch.cat(
        [w[:, None], wx, (wx[:, :, None] * x[:, None, :]).reshape(E, 9)],
        dim=1))                                                    # (N,13)
    q2, V1 = by_frame[:, 0], by_frame[:, 1:4]
    Q1 = by_frame[:, 4:].reshape(N, 3, 3)
    q3 = sums.landmark.sum(w)
    by_pair = torch.cat([w[:, None], wx], dim=1)                   # (E,4)
    if sums.pair is not None:
        by_pair = sums.pair.sum(by_pair)
    V3 = torch.zeros((N, M), dtype=dtype, device=dev).index_put_(
        sums.at, by_pair[:, 0])
    V2 = torch.zeros((N, M, 3), dtype=dtype, device=dev).index_put_(
        sums.at, by_pair[:, 1:]).permute(0, 2, 1)                  # (N,3,M)

    inv_sqrt_q3 = 1.0 / torch.sqrt(q3)
    V3_bar = V3[1:]                                                # (N-1, M)
    V3_bar_F = V3_bar * inv_sqrt_q3[None, :]
    VT = torch.diag(q2[1:]) - V3_bar_F @ V3_bar_F.T                # (N-1, N-1)

    # Vtp^T = [V1^T; -V2^T] : (N+M, 3N)
    V1_big = torch.zeros((N, 3 * N), dtype=dtype, device=dev)
    rows = torch.arange(N, device=dev)
    cols = 3 * rows[:, None] + torch.arange(3, device=dev)[None, :]
    V1_big[rows[:, None], cols] = V1          # row i has v1_i in block i
    V2_flat = V2.reshape(3 * N, M)            # flat row = 3*frame + coord
    Vtp_T = torch.cat([V1_big, -V2_flat.T], dim=0)                 # (N+M, 3N)

    def qtp_apply(A):
        """Qtp @ A for A (N+M, k): Qtp = [[diag(q2), -V3], [-V3^T, diag(q3)]]."""
        At, Ap = A[:N], A[N:]
        top = q2[:, None] * At - V3 @ Ap
        bot = -V3.T @ At + q3[:, None] * Ap
        return torch.cat([top, bot], dim=0)

    a0 = torch.cat([torch.zeros(N - 1, dtype=dtype, device=dev), -V3[0]])
    RHS_left = qtp_apply(Vtp_T)[1:]                                # (N+M-1, 3N)
    RHS = torch.cat([RHS_left, a0[:, None]], dim=1)

    RHS_A, RHS_B = RHS[: N - 1], RHS[N - 1:]
    L = _cholesky_or_nan(VT)
    for _ in range(2):                                   # creatematrix.py:275-280
        RHS_B = RHS_B * inv_sqrt_q3[:, None]
        RHS_A = torch.cholesky_solve(RHS_A + V3_bar_F @ RHS_B, L)
        RHS_B = RHS_B + V3_bar_F.T @ RHS_A
        RHS_B = RHS_B * inv_sqrt_q3[:, None]

    A = torch.cat([
        torch.zeros((1, 3 * N), dtype=dtype, device=dev),
        -RHS_A[:, :-1],
        -RHS_B[:, :-1],
    ], dim=0)                                                      # (N+M, 3N)
    v2 = torch.cat([RHS_A[:, -1], RHS_B[:, -1]])                   # (N+M-1,)

    S = 1.0 + torch.dot(a0, v2)
    # rank-1 anchor correction, one batched outer product (:289-305)
    proj = a0 @ A[1:]                                              # (3N,)
    A[1:] -= torch.outer(v2, proj) / S
    Abar = A[1:]

    QA = qtp_apply(A)                                              # (N+M, 3N)
    C = A.T @ QA
    T = Vtp_T.T @ A                                                # Vtp @ A
    C = C + T + T.T

    # += Q1 block diagonal
    bi = 3 * torch.arange(N, device=dev)
    r3 = bi[:, None, None] + torch.arange(3, device=dev)[None, :, None]
    c3 = bi[:, None, None] + torch.arange(3, device=dev)[None, None, :]
    C.index_put_((r3, c3), Q1, accumulate=True)

    C = 0.5 * (C + C.T)
    return (C.to(torch.float64), Abar.to(torch.float64),
            S.to(torch.float64))


def create_matrix_arrays(weights, edges, landmarks, precision: str = "f64",
                         device=None):
    """Assemble (C, Abar) in memory on ``device`` (None = the CUDA card).

    Args:
      weights: (E,) observation weights.
      edges: (E, 2) int array of 1-based ``[frame, landmark]`` ids.
      landmarks: (E, 3) depth-lifted 3-D observations in camera frame.
      precision: "f64" (reference parity) or "mixed" (f32 heavy middle,
        ~1e-6 relative C error; redone in f64 if the f32 build breaks down).

    Returns ``C`` (3N, 3N) and ``Abar`` (N+M-1, 3N), float64 tensors on
    ``device``.
    """
    dev = resolve_device(device)
    edges = np.asarray(edges)
    weights = np.asarray(weights, dtype=np.float64).ravel()
    landmarks = np.asarray(landmarks, dtype=np.float64)
    N = int(edges[:, 0].max())
    M = int(edges[:, 1].max())
    sums = _edge_sums(edges[:, 0] - 1, edges[:, 1] - 1, N, M, dev)
    w = torch.as_tensor(weights, dtype=torch.float64, device=dev)
    x = torch.as_tensor(landmarks, dtype=torch.float64, device=dev)
    dtype = torch.float32 if precision == "mixed" else torch.float64
    C, Abar, S = _assemble(w, x, sums, N, M, dtype=dtype)
    if dtype == torch.float32:
        # f32 breakdown anywhere — Cholesky NaNs (S) or overflow in C/Abar —
        # redoes the assembly in f64 (one batched host read)
        ok = bool(torch.isfinite(C).all() & torch.isfinite(Abar).all()
                  & torch.isfinite(S))
        if not ok:
            C, Abar, S = _assemble(w, x, sums, N, M)
    if float(S) == 0.0:
        raise ValueError("S is 0")  # anchor guard (creatematrix.py:301-302)
    return C, Abar


def create_matrix(weights, edges, landmarks, output_path, device=None):
    """File-emitting wrapper matching the reference signature: writes
    ``Q.bin`` and ``Abar.bin`` to ``output_path`` and returns ``(C, Abar)``."""
    C, Abar = create_matrix_arrays(weights, edges, landmarks, device=device)
    save_matrix_to_bin(os.path.join(output_path, "Abar.bin"),
                       Abar.cpu().numpy())
    save_matrix_to_bin(os.path.join(output_path, "Q.bin"), C.cpu().numpy())
    return C, Abar
