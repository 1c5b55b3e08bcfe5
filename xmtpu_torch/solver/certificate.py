"""Dual certificate of global optimality for the XM SDP relaxation.

PyTorch counterpart of the dense branch of ``xmtpu/solver/certificate.py``
(see that module for the reference semantics).  At the Burer-Monteiro point
``X = sR sR^T`` the dual multiplier ``y`` solves block-diagonal normal
equations exactly (one 6x6 system for camera 0, an (n-1)-batch of 5x5 for
the rest), and ``Z = C + lam-correction - A^*(y)`` is tested for
``lam_min(Z) > -bound``.

The 'auto' dense path answers that test with a Cholesky factorization of
``Z + bound I`` (``torch.linalg.cholesky_ex``: its ``info`` flags failure
where the reference's Cholesky returns NaN), refines ``lam_min`` by
inverse Lanczos (3n <= 1500) or the deflated two-block Lanczos bound
(larger), and runs Lanczos on ``Z`` for the escape direction only when the
probe fails.  Every size takes this path on both devices (the reference's
CPU branch); the matvec certificate flow arrives with the implicit slice.

Lanczos start vectors come from ``ops.lanczos.start_vector``, not
``jax.random``, so escape directions (and their sign) differ from the
reference's; certified results do not.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from xmtpu_torch._device import resolve_device
from xmtpu_torch.ops.lanczos import lanczos_min_eig
from xmtpu_torch.ops.qop import DenseQ, as_qop

# above this many rows the 'auto' refinement switches from inverse Lanczos
# to the deflated two-block bound (and 'auto' min-eig from eigh to Lanczos)
LANCZOS_AUTO_DIM = 1500


class CertificateResult(NamedTuple):
    certified: bool
    v: torch.Tensor        # (3n,) min-eigenvalue direction of Z (escape dir)
    lam_min: float
    gap: float
    dual: float
    primal: float
    info: "dict | None" = None


def _camera0_patterns(dtype=torch.float64, device=None) -> torch.Tensor:
    """Six symmetric basis patterns in the reference's column order
    (0,0),(0,1),(0,2),(1,1),(1,2),(2,2)."""
    P = np.zeros((6, 3, 3))
    order = [(0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)]
    for c, (i, j) in enumerate(order):
        if i == j:
            P[c, i, i] = 1.0
        else:
            P[c, i, j] = 0.5
            P[c, j, i] = 0.5
    return torch.as_tensor(P, dtype=dtype, device=device)


def _camera_patterns(dtype=torch.float64, device=None) -> torch.Tensor:
    """Five patterns per camera i>=1 in reference order: diag(0)-diag(1),
    diag(1)-diag(2), offdiag(0,1), offdiag(0,2), offdiag(1,2)."""
    P = np.zeros((5, 3, 3))
    P[0, 0, 0], P[0, 1, 1] = 0.5, -0.5
    P[1, 1, 1], P[1, 2, 2] = 0.5, -0.5
    P[2, 0, 1] = P[2, 1, 0] = 0.5
    P[3, 0, 2] = P[3, 2, 0] = 0.5
    P[4, 1, 2] = P[4, 2, 1] = 0.5
    return torch.as_tensor(P, dtype=dtype, device=device)


def _solve_spd_small(G, g):
    """Batched SPD solve for tiny k x k systems via unrolled Cholesky +
    substitution.  G: (..., k, k), g: (..., k) -> (..., k)."""
    k = G.shape[-1]
    # underflow-level ridge: an all-zero Gram block solves to y = 0
    ridge = 1e-300 if G.dtype == torch.float64 else 1e-30
    L = [[None] * k for _ in range(k)]
    for i in range(k):
        s = G[..., i, i] + ridge
        for j in range(i):
            s = s - L[i][j] * L[i][j]
        L[i][i] = torch.sqrt(s)
        for r in range(i + 1, k):
            s = G[..., r, i]
            for j in range(i):
                s = s - L[r][j] * L[i][j]
            L[r][i] = s / L[i][i]
    z = [None] * k
    for i in range(k):
        s = g[..., i]
        for j in range(i):
            s = s - L[i][j] * z[j]
        z[i] = s / L[i][i]
    y = [None] * k
    for i in reversed(range(k)):
        s = z[i]
        for j in range(i + 1, k):
            s = s - L[j][i] * y[j]
        y[i] = s / L[i][i]
    return torch.stack(y, dim=-1)


def _min_eig_bound(n: int) -> float:
    """The reference's effective min-eig acceptance bound schedule."""
    return 1e-4 if n <= 2000 else 1e-3


def _z_and_dual(C, sR, lam):
    """The dual matrix ``Z`` (a new tensor) and the dual objective (0-d)."""
    three_n, o = sR.shape
    n = three_n // 3
    dtype, dev = sR.dtype, sR.device
    lam = float(lam)
    S = sR.reshape(n, 3, o)

    # Z = C + 2 lam (x_ii - 1) on the (3i, 3i) entries
    x_ii = torch.sum(S[:, 0, :] ** 2, dim=-1)                     # (n,)
    idx0 = 3 * torch.arange(n, device=dev)
    Z = C.clone()
    Z[idx0, idx0] += 2.0 * lam * (x_ii - 1.0)

    B = (Z @ sR).reshape(n, 3, o)

    # exact dual least-squares, block-diagonal normal equations
    P0 = _camera0_patterns(dtype, dev)                             # (6,3,3)
    M0 = torch.einsum("cab,bo->cao", P0, S[0])
    G0 = torch.einsum("cao,dao->cd", M0, M0)
    g0 = torch.einsum("cao,ao->c", M0, B[0])
    y0 = _solve_spd_small(G0, g0)                                  # (6,)

    P = _camera_patterns(dtype, dev)                               # (5,3,3)
    M = torch.einsum("cab,nbo->ncao", P, S[1:])
    G = torch.einsum("ncao,ndao->ncd", M, M)
    g = torch.einsum("ncao,nao->nc", M, B[1:])
    y = _solve_spd_small(G, g)                                     # (n-1,5)

    # Z <- Z - A^*(y): subtract per-camera 3x3 diagonal blocks
    D0 = torch.einsum("c,cab->ab", y0, P0)
    D = torch.einsum("nc,cab->nab", y, P)
    Dall = torch.cat([D0[None], D], dim=0)                         # (n,3,3)
    base = 3 * torch.arange(n, device=dev)
    ar = torch.arange(3, device=dev)
    rows = base[:, None, None] + ar[None, :, None]
    cols = base[:, None, None] + ar[None, None, :]
    Z.index_put_((rows, cols), -Dall, accumulate=True)

    dual = y0[0] + y0[3] + y0[5] + lam * torch.sum(1.0 - x_ii ** 2)
    return Z, dual


def _deflated_min_eig(zmul_mat, sR, v0=None, num_iters: int = 96):
    """Deflation-based lower bound on ``lam_min(Z)`` from its matvec: split
    Z over ``U = orth(sR)`` (the near-kernel at a converged point) and its
    complement; exact eigh of the o x o block, projected Lanczos on the
    complement, minus the coupling norm.  Returns ``(lam_min_est,
    lam_min_lb, v)`` as (0-d, 0-d, (3n,)) tensors."""
    three_n, o = sR.shape
    G = sR.T @ sR
    wG, VG = torch.linalg.eigh(G)
    wG = torch.clamp(wG, min=1e-30)
    U = sR @ ((VG / torch.sqrt(wG)) @ VG.T)

    ZU = zmul_mat(U)                                               # (3n, o)
    A_small = U.T @ ZU
    A_small = 0.5 * (A_small + A_small.T)
    wA, VA = torch.linalg.eigh(A_small)
    lam_U = wA[0]
    v_U = U @ VA[:, 0]
    b_norm = torch.linalg.norm(ZU - U @ A_small)                   # ||P Z U||

    def pzp(x):
        x = x - U @ (U.T @ x)
        y = zmul_mat(x[:, None])[:, 0]
        return y - U @ (U.T @ y)

    if v0 is not None:
        v0 = v0 - U @ (U.T @ v0)
    lam_perp, v_perp, resid = lanczos_min_eig(pzp, three_n, v0=v0,
                                              num_iters=num_iters,
                                              device=sR.device)
    lam_min_est = torch.minimum(lam_U, lam_perp)
    lam_min_lb = torch.minimum(lam_U, lam_perp - resid) - b_norm
    v = v_perp if bool(lam_perp < lam_U) else v_U
    return lam_min_est, lam_min_lb, v


def _build_z_dual_psd(C, sR, lam, shift):
    """Z, dual, the Cholesky PSD probe of ``Z + shift I`` and a refinement
    of ``lam_min(Z)``.  Returns ``(Z, dual, psd, lam_min_est, lam_min_lb,
    v)`` with host floats/bool for the scalars."""
    Z, dual = _z_and_dual(C, sR, lam)
    dim = Z.shape[0]
    eye = torch.eye(dim, dtype=Z.dtype, device=Z.device)
    A = Z + shift * eye
    L, info = torch.linalg.cholesky_ex(A)
    psd = bool((info == 0) & torch.isfinite(L).all())
    del A

    if dim <= LANCZOS_AUTO_DIM:
        Lsafe = L if psd else eye
        # Lanczos on (Z + shift I)^{-1}: Z's near-zero cluster becomes the
        # inverse's top, well-separated end (24 iterations suffice)
        Ainv = torch.cholesky_solve(eye, Lsafe)
        Ainv = 0.5 * (Ainv + Ainv.T)
        theta_neg, v, resid = lanczos_min_eig(lambda x: -(Ainv @ x), dim,
                                              num_iters=24, device=Z.device)
        theta = -theta_neg
        lam_min_est = 1.0 / theta - shift
        lam_min_lb = 1.0 / (theta + resid) - shift
        est, lb = (float(x) for x in torch.stack([lam_min_est, lam_min_lb]))
    else:
        # reporting only (the probe already decided): the deflated bound
        del L
        lam_min_est, lam_min_lb, v = _deflated_min_eig(lambda X: Z @ X, sR)
        est, lb = (float(x) for x in torch.stack([lam_min_est, lam_min_lb]))
        if psd:
            # the probe itself proves lam_min >= -shift
            lb = max(lb, -shift)
            est = min(est, shift)
    return Z, float(dual), psd, est, lb, v


def _lanczos_escape(Z, v0=None):
    return lanczos_min_eig(lambda x: Z @ x, Z.shape[0], v0=v0,
                           device=Z.device)


def _certify_core(C, sR, lam, primal, v0=None, use_lanczos: bool = False):
    """Z, exact dual, and the minimum eigenpair by eigh or Lanczos.
    Returns host ``(lam_min, v, gap, dual, resid)``."""
    n = sR.shape[0] // 3
    Z, dual = _z_and_dual(C, sR, lam)
    if use_lanczos:
        lam_min, v, resid = lanczos_min_eig(lambda x: Z @ x, Z.shape[0],
                                            v0=v0, device=Z.device)
        lam_min, resid = float(lam_min), float(resid)
    else:
        w, V = torch.linalg.eigh(Z)
        lam_min, v, resid = float(w[0]), V[:, 0], 0.0
    K = 3.0 * n
    dual = float(dual)
    gap = float(primal) - dual - K * min(0.0, lam_min - resid)
    return lam_min, v, gap, dual, resid


def finish_auto_certificate(Z, n: int, bound: float, primal_v: float,
                            dual_v: float, psd_v: bool, lam_min_v: float,
                            lam_min_lb_v: float, v_inv, v0=None):
    """Completion of the 'auto' dense certificate from the outputs of
    :func:`_build_z_dual_psd`.  Returns ``(certified, v, lam_min, gap,
    dual)``; device work (Lanczos escape on Z) only when uncertified."""
    K = 3.0 * n
    if psd_v:
        gap = primal_v - dual_v - K * min(0.0, lam_min_lb_v)
        return True, v_inv, float(lam_min_v), gap, float(dual_v)
    lam_min, v, resid = _lanczos_escape(Z, v0=v0)
    lam_min, resid = float(lam_min), float(resid)
    gap = primal_v - dual_v - K * min(0.0, lam_min - resid)
    certified = (gap / primal_v < 1e-3) or (lam_min - resid > -bound)
    return certified, v, lam_min, gap, float(dual_v)


def certify(C, sR, lam, primal, verbose: bool = False,
            method: str = "auto", v0=None, device=None) -> CertificateResult:
    """Check global optimality of the rank-o point ``sR`` on a dense cost
    matrix.  ``method``: "auto" (Cholesky probe), "eigh" or "lanczos";
    ``v0``: optional Lanczos start vector; ``device``: None = the CUDA card,
    ``"cpu"`` for the host."""
    dev = resolve_device(device)
    Q = as_qop(C, device=dev)
    if not isinstance(Q, DenseQ):
        raise NotImplementedError(
            f"certify: {type(Q).__name__} is not ported yet (dense only)")
    Cm = Q.C.to(torch.float64)
    sR = torch.as_tensor(sR, dtype=torch.float64, device=dev)
    if v0 is not None:
        v0 = torch.as_tensor(v0, dtype=torch.float64, device=dev)
    n = sR.shape[0] // 3
    primal = float(primal)
    bound = _min_eig_bound(n)

    if method == "auto":
        Z, dual, psd, lme, lmlb, v_inv = _build_z_dual_psd(Cm, sR, lam, bound)
        certified, v, lam_min, gap, dual = finish_auto_certificate(
            Z, n, bound, primal, dual, psd, lme, lmlb, v_inv, v0=v0)
    else:
        lam_min, v, gap, dual, resid = _certify_core(
            Cm, sR, lam, primal, v0=v0, use_lanczos=method == "lanczos")
        # the Lanczos Ritz value only bounds lam_min from above
        certified = (gap / primal < 1e-3) or (lam_min - resid > -bound)
    if verbose:
        print(f"[certify] primal={primal:.6e} dual={dual:.6e} "
              f"gap={gap:.3e} lam_min={lam_min:.3e} "
              f"certified={bool(certified)}")
    return CertificateResult(bool(certified), v, lam_min, gap, dual, primal)
