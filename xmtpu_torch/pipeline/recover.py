"""Solution recovery / rounding: factor -> rotations, scales, poses, points.

PyTorch counterpart of ``xmtpu/pipeline/recover.py``: the same host-side
numpy post-processing (thin SVD of the factor above rank 3, per-camera
scale/frame split, gauge fix to camera 0, global sign vote, SO(3)
projection); the translation/landmark solve and the suboptimality report go
through the cost operator on its device — ``Q.recover_y`` for the implicit
operator, the dense ``Abar`` product otherwise.
"""

from __future__ import annotations

import numpy as np
import torch

from xmtpu_torch.ops.qop import as_qop
from xmtpu_torch.utils.timer import spanned


def _round(R, s, lam, qop, verbose):
    """Shared rounding.  Returns ``(R_real (3, 3N), s_real (N,), sR_real
    (3, 3N))``."""
    R = np.asarray(R, np.float64)
    s = np.asarray(s, np.float64).ravel()
    N = s.shape[0]
    o = R.shape[1]
    sR_blocks = R.reshape(N, 3, o) * s[:, None, None]

    if o > 3:
        sR = sR_blocks.reshape(3 * N, o)
        # top-3 eigenpairs of X = sR sR^T from the thin SVD of the factor
        U, sv, _ = np.linalg.svd(sR, full_matrices=False)
        eig_vals = sv * sv
        sR_real = (U[:, :3] * sv[:3]).T
        if abs(eig_vals[3] / eig_vals[2]) < 1e-3:
            if verbose:
                print("Optimal rank is 3")
        else:
            # <Q, X_new - X> through the factors: tr(A^T Q A) - tr(B^T Q B)
            dev = qop.device
            A = torch.as_tensor(sR_real.T.copy(), device=dev)
            B = torch.as_tensor(sR, device=dev)
            subopt = (float(torch.sum(A * qop.apply(A))
                            - torch.sum(B * qop.apply(B)))
                      + lam * np.sum((np.einsum("ij,ij->i", sR_real.T,
                                                sR_real.T) - 1) ** 2) / 3
                      - lam * np.sum((np.einsum("ij,ij->i", sR, sR) - 1)
                                     ** 2) / 3)
            if verbose:
                print("suboptimality: ", subopt)
        B = sR_real.reshape(3, N, 3).transpose(1, 0, 2)
    else:
        B = sR_blocks.transpose(0, 2, 1)                 # B_i = (s_i R_i)^T

    s_real = np.linalg.norm(B, axis=(1, 2)) / np.sqrt(3.0)
    Rb = B / s_real[:, None, None]                       # (N, 3, 3) c2w
    Rb = np.einsum("ab,nbc->nac", Rb[0].T.copy(), Rb)    # gauge: camera 0
    U, _, Vt = np.linalg.svd(Rb)
    dets = np.linalg.det(U @ Vt)
    negative = int(np.sum(dets < 0))
    if negative > 0 and verbose:
        print("warning: some det(R) < 0")
    if negative > N / 2:
        Rb = -Rb
        U, _, Vt = np.linalg.svd(Rb)
    Rb = U @ Vt                                          # project to O(3)
    sB = Rb * s_real[:, None, None]
    R_real = Rb.transpose(1, 0, 2).reshape(3, 3 * N)
    sR_real = sB.transpose(1, 0, 2).reshape(3, 3 * N)
    return R_real, s_real, sR_real


def _split_y(ybar_est, N):
    y_est = np.hstack((np.zeros((3, 1)), ybar_est.T))    # (3, N+M)
    return y_est[:, :N], y_est[:, N:]


@spanned("xm.recover", leaf=True)
def recover_XM_implicit(Q, R, s, lam, verbose: bool = True):
    """Recovery through the implicit operator — no dense ``Abar``: the
    translation/landmark solve is ``Q.recover_y``.  Returns ``(R_real,
    s_real, p_est, t_est)`` as :func:`recover_XM`."""
    R_real, s_real, sR_real = _round(R, s, lam, Q, verbose)
    sRt = torch.as_tensor(sR_real.T.copy(), device=as_qop(Q).device)
    ybar_est = Q.recover_y(sRt).cpu().numpy()
    t_est, p_est = _split_y(ybar_est, s_real.shape[0])
    return R_real, s_real, p_est, t_est


@spanned("xm.recover", leaf=True)
def recover_XM(Q, R, s, Abar, lam, verbose: bool = True):
    """Recover rotations / scales / translations / landmark positions.

    Args:
      Q: (3N, 3N) cost matrix or operator (the suboptimality report only).
      R: (3N, o) solved factor.
      s: (N,) or (N, 1) extended scales.
      Abar: (N+M-1, 3N) recovery operator (tensor or array).
      lam: scale regularization weight.

    Returns ``(R_real (3, 3N), s_real (N,), p_est (3, M), t_est (3, N))``.
    """
    R_real, s_real, sR_real = _round(R, s, lam, as_qop(Q), verbose)
    if isinstance(Abar, torch.Tensor):
        sRt = torch.as_tensor(sR_real.T.copy(), dtype=Abar.dtype,
                              device=Abar.device)
        ybar_est = (Abar @ sRt).cpu().numpy()
    else:
        ybar_est = np.asarray(Abar, np.float64) @ sR_real.T
    t_est, p_est = _split_y(ybar_est, s_real.shape[0])
    return R_real, s_real, p_est, t_est
