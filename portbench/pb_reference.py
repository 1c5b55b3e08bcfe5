"""Plain reference of a certified scaled-bundle-adjustment solve.

Plain PyTorch on one device, in the ``dtype`` asked for.  It imports
nothing of the program: it works out the cost matrix, the dual
certificate, the rounding and the recovered translations and landmarks
again from the observations that the benchmark made, and reads the
program's outputs only to judge them.

The problem, one column of the factor at a time: camera i's block of the
factor is a 3 x o matrix ``S_i = s_i R_i``, camera 0's translation is fixed
at 0, and an observation e = (i, l) with lifted point ``x_e`` and weight
``w_e`` has the residual ``p_l - t_i - S_i^T x_e``.  Its sum of squares is a
quadratic form in ``z = [y; t_1..t_{N-1}; p_1..p_M]`` (y the 3N rows of the
factor), ``H = J^T W J``.  Minimising over the translations and landmarks
in closed form leaves ``f(S) = tr(S^T C S)`` with ``C`` the Schur
complement of H on y.  Here it is eliminated in two plain block steps,
landmarks first (their block is diagonal), then translations (a dense
Cholesky): no rank-one anchor correction, no segment sums.

The semidefinite relaxation constrains camera 0's block ``X_00 = I`` and
every other ``X_ii`` to a multiple of I.  At a factor S with ``S_i S_i^T =
s_i^2 I`` the least-squares multiplier of ``(C S)_i = L_i S_i`` is
``L_i = P(G_i S_i^T) / s_i^2`` with P the projection onto the symmetric
(camera 0) or symmetric traceless (the others) 3 x 3 matrices; the dual
value is ``tr(L_0)`` and ``Z = C - blkdiag(L)`` certifies global
optimality when it is positive semidefinite.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Elimination(NamedTuple):
    """The reduced cost ``C`` (3N, 3N) and what recovering translations and
    landmarks from a factor needs."""

    C: torch.Tensor
    Ayt: torch.Tensor      # (3N, N-1) factor-translation block, landmarks out
    Ltt: torch.Tensor      # Cholesky factor of the translation block
    Hyp: torch.Tensor      # (3N, M)
    Htp: torch.Tensor      # (N-1, M)
    inv_q3: torch.Tensor   # (M,) inverse landmark weights


def eliminate(edges, weights, landmarks, N: int, M: int, dtype,
              device) -> Elimination:
    """The Schur complement of the SBA quadratic form on the factor rows."""
    e = torch.as_tensor(np.asarray(edges), dtype=torch.int64, device=device)
    f, l = e[:, 0] - 1, e[:, 1] - 1
    w = torch.as_tensor(np.asarray(weights), dtype=dtype, device=device)
    x = torch.as_tensor(np.asarray(landmarks), dtype=dtype, device=device)
    wx = w[:, None] * x
    three = torch.arange(3, device=device)

    rows = (3 * f[:, None] + three[None, :]).reshape(-1)
    Hyp = torch.zeros((3 * N, M), dtype=dtype, device=device)
    Hyp.index_put_((rows, l.repeat_interleave(3)), -wx.reshape(-1),
                   accumulate=True)
    Hyt = torch.zeros((3 * N, N), dtype=dtype, device=device)
    Hyt.index_put_((rows, f.repeat_interleave(3)), wx.reshape(-1),
                   accumulate=True)
    Htp = torch.zeros((N, M), dtype=dtype, device=device)
    Htp.index_put_((f, l), -w, accumulate=True)
    q2 = torch.zeros(N, dtype=dtype, device=device).index_add_(0, f, w)
    q3 = torch.zeros(M, dtype=dtype, device=device).index_add_(0, l, w)
    Q1 = torch.zeros((N, 3, 3), dtype=dtype, device=device).index_add_(
        0, f, wx[:, :, None] * x[:, None, :])
    Hyt, Htp, q2 = Hyt[:, 1:], Htp[1:], q2[1:]       # t_0 = 0
    inv_q3 = 1.0 / q3

    HypD = Hyp * inv_q3[None, :]
    Ayy = -(HypD @ Hyp.T)
    torch.diagonal(Ayy.view(N, 3, N, 3), dim1=0, dim2=2).add_(
        Q1.permute(1, 2, 0))
    Ayt = Hyt - HypD @ Htp.T
    del HypD
    Att = torch.diag(q2) - (Htp * inv_q3[None, :]) @ Htp.T
    Ltt = torch.linalg.cholesky(Att)
    del Att
    C = Ayy - Ayt @ torch.cholesky_solve(Ayt.T.contiguous(), Ltt)
    del Ayy
    C = 0.5 * (C + C.T)
    return Elimination(C, Ayt, Ltt, Hyp, Htp, inv_q3)


def positions(el: Elimination, Y: torch.Tensor):
    """The translations ``(N-1, o)`` and landmarks ``(M, o)`` that minimise
    the cost for the factor rows ``Y (3N, o)``."""
    t = -torch.cholesky_solve(el.Ayt.T @ Y, el.Ltt)
    p = -el.inv_q3[:, None] * (el.Hyp.T @ Y + el.Htp.T @ t)
    return t, p


def scaled_factor(R, s_ex, dtype, device) -> torch.Tensor:
    """``S`` (3N, o) from the program's frames (3N, o) and scales (N,)."""
    R = torch.as_tensor(np.asarray(R), dtype=dtype, device=device)
    s = torch.as_tensor(np.asarray(s_ex).ravel(), dtype=dtype, device=device)
    n = s.shape[0]
    return (R.reshape(n, 3, -1) * s[:, None, None]).reshape(3 * n, -1)


def objective(C: torch.Tensor, S: torch.Tensor) -> float:
    return float(torch.sum(S * (C @ S)))


class Certificate(NamedTuple):
    primal: float
    dual: float
    lam_min: float     # an upper estimate of lam_min(Z), exact on failure
    psd_at: bool       # Cholesky of Z + bound I succeeded
    gap: float         # primal - dual - 3n min(0, lam_min)


def certificate(C: torch.Tensor, S: torch.Tensor, bound: float,
                generator: torch.Generator) -> Certificate:
    """The dual certificate at the factor ``S`` (3N, o).  ``lam_min`` comes
    from Rayleigh-Ritz on a block inverse iteration with ``(Z + bound I)``
    where its Cholesky succeeds (so it lies above ``-bound``), else from
    ``eigvalsh(Z)``."""
    n3, o = S.shape
    n = n3 // 3
    Sb = S.reshape(n, 3, o)
    G = (C @ S).reshape(n, 3, o)
    primal = float(torch.sum(Sb * G))
    GS = G @ Sb.transpose(1, 2)                                   # (n,3,3)
    s2 = torch.einsum("nao,nao->n", Sb, Sb) / 3.0
    L = 0.5 * (GS + GS.transpose(1, 2)) / s2[:, None, None]
    eye = torch.eye(3, dtype=S.dtype, device=S.device)
    tr = torch.einsum("naa->n", L)
    L[1:] -= (tr[1:] / 3.0)[:, None, None] * eye
    dual = float(torch.einsum("aa->", L[0]))

    Z = C.clone()
    torch.diagonal(Z.view(n, 3, n, 3), dim1=0, dim2=2).sub_(L.permute(1, 2, 0))
    Z.diagonal().add_(bound)
    chol, info = torch.linalg.cholesky_ex(Z)
    psd_at = bool(info == 0) and bool(torch.isfinite(chol).all())
    if psd_at:
        k = o + 4
        V = torch.randn((n3, k), generator=generator, dtype=torch.float64,
                        device=generator.device).to(S.dtype)
        for _ in range(12):
            V, _ = torch.linalg.qr(torch.cholesky_solve(V, chol))
        del chol
        Z.diagonal().sub_(bound)
        T = V.T @ (Z @ V)
        lam_min = float(torch.linalg.eigvalsh(0.5 * (T + T.T))[0])
    else:
        del chol
        Z.diagonal().sub_(bound)
        lam_min = float(torch.linalg.eigvalsh(Z)[0])
    gap = primal - dual - 3.0 * n * min(0.0, lam_min)
    return Certificate(primal, dual, lam_min, psd_at, gap)


def rounding(R, s_ex, dtype, device):
    """Rotations and scales from the program's factor: the top three
    directions of ``X = S S^T`` (the factor itself at rank 3), gauge fixed
    to camera 0, projected onto O(3) and sign-voted to SO(3).  Returns
    ``(Rb (N, 3, 3) camera-to-world, s (N,), Y (3N, 3))`` with ``Y`` the
    rounded factor rows that :func:`positions` takes."""
    S = scaled_factor(R, s_ex, dtype, device)
    n = S.shape[0] // 3
    if S.shape[1] > 3:
        U, sv, _ = torch.linalg.svd(S, full_matrices=False)
        S = U[:, :3] * sv[:3]
    B = S.reshape(n, 3, 3).transpose(1, 2)                         # (s R_i)
    scale = torch.linalg.norm(B, dim=(1, 2)) / np.sqrt(3.0)
    Rb = B / scale[:, None, None]
    Rb = Rb[0].T @ Rb
    U, _, Vh = torch.linalg.svd(Rb)
    if int((torch.linalg.det(U @ Vh) < 0).sum()) > n / 2:
        U, _, Vh = torch.linalg.svd(-Rb)
    Rb = U @ Vh
    Y = (Rb * scale[:, None, None]).transpose(1, 2).reshape(3 * n, 3)
    return Rb, scale, Y
