"""Dual certificate of global optimality for the XM SDP relaxation.

PyTorch counterpart of ``xmtpu/solver/certificate.py`` (see that module
for the reference semantics).  At the Burer-Monteiro point
``X = sR sR^T`` the dual multiplier ``y`` solves block-diagonal normal
equations exactly (one 6x6 system for camera 0, an (n-1)-batch of 5x5 for
the rest), and ``Z = C + lam-correction - A^*(y)`` is tested for
``lam_min(Z) > -bound``.

The 'auto' dense path answers that test with a Cholesky factorization of
``Z + bound I`` (``torch.linalg.cholesky_ex``: its ``info`` flags failure
where the reference's Cholesky returns NaN), refines ``lam_min`` by
inverse Lanczos (3n <= 1500) or the deflated two-block Lanczos bound
(larger), and runs Lanczos on ``Z`` for the escape direction only when the
probe fails.  Every dense size takes this path on both devices (the
reference's CPU branch).

Implicit operators (``ops/schurq.py``) take the matvec flow: ``Z`` is never
formed; the deflated two-block Lanczos bound and, for structurally PSD
operators, the O(n) Delta-block bound decide, with the convergence-gated
(deflated, block-Jacobi preconditioned) CG shift probe as the decider when
neither is conclusive.  The reference's ``lax.while_loop`` chunks are host
loops here; its decisions, budgets and the weak points ``ADVICE.md`` lists
(``verify_k=48``, the witness-free subspace refutation, ``eta = 1e30``
invalidating the fast Krylov bound) are kept as they are.
``fast="auto"`` derives no fast operator on either device (the reference's
CPU branch); an explicit ``fast=Q.two_float()`` runs the per-iteration
matvecs through it with every decision anchored to the exact operator.

Lanczos start vectors come from ``ops.lanczos.start_vector``, not
``jax.random``, so escape directions (and their sign) differ from the
reference's; certified results do not.  The probe's start vectors are the
reference's own (numpy ``default_rng(7 + k)``).
"""

from __future__ import annotations

import time
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


def _dual_blocks(S, B):
    """Exact dual least-squares through the block-diagonal normal
    equations.  ``S`` and ``B = Z0 sR`` are (n, 3, o) with ``Z0`` the lam-
    corrected cost.  Returns ``(y0 (6,), Dall (n, 3, 3))``: camera 0's
    multiplier and every camera's ``A^*(y)`` block."""
    dtype, dev = S.dtype, S.device
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

    D0 = torch.einsum("c,cab->ab", y0, P0)
    D = torch.einsum("nc,cab->nab", y, P)
    return y0, torch.cat([D0[None], D], dim=0)                     # (n,3,3)


def _z_and_dual(C, sR, lam):
    """The dual matrix ``Z`` (a new tensor) and the dual objective (0-d)."""
    three_n, o = sR.shape
    n = three_n // 3
    dev = sR.device
    lam = float(lam)
    S = sR.reshape(n, 3, o)

    # Z = C + 2 lam (x_ii - 1) on the (3i, 3i) entries
    x_ii = torch.sum(S[:, 0, :] ** 2, dim=-1)                     # (n,)
    idx0 = 3 * torch.arange(n, device=dev)
    Z = C.clone()
    Z[idx0, idx0] += 2.0 * lam * (x_ii - 1.0)

    y0, Dall = _dual_blocks(S, (Z @ sR).reshape(n, 3, o))

    # Z <- Z - A^*(y): subtract per-camera 3x3 diagonal blocks
    base = 3 * torch.arange(n, device=dev)
    ar = torch.arange(3, device=dev)
    rows = base[:, None, None] + ar[None, :, None]
    cols = base[:, None, None] + ar[None, None, :]
    Z.index_put_((rows, cols), -Dall, accumulate=True)

    dual = y0[0] + y0[3] + y0[5] + lam * torch.sum(1.0 - x_ii ** 2)
    return Z, dual


def _orth(sR):
    """``U = sR (sR'sR)^{-1/2}``, an orthonormal basis of span(sR), through
    the o x o Gram eigendecomposition."""
    wG, VG = torch.linalg.eigh(sR.T @ sR)
    wG = torch.clamp(wG, min=1e-30)
    return sR @ ((VG / torch.sqrt(wG)) @ VG.T)


def _deflated_min_eig(zmul_mat, sR, v0=None, with_parts: bool = False,
                      num_iters: int = 96, zmul_head=None, eta=None):
    """Deflation-based lower bound on ``lam_min(Z)`` from its matvec: split
    Z over ``U = orth(sR)`` (the near-kernel at a converged point) and its
    complement; exact eigh of the o x o block, projected Lanczos on the
    complement, minus the coupling norm.  Returns ``(lam_min_est,
    lam_min_lb, v)`` as (0-d, 0-d, (3n,)) tensors, plus ``(lam_U, b_norm)``
    with ``with_parts``.

    ``zmul_head``: the EXACT operator's closure for the U-block head when
    ``zmul_mat`` is a fast approximate one running the Krylov loop; ``eta``
    (a spectral bound on its error) then widens the projected-Lanczos lower
    bound (Weyl)."""
    three_n, o = sR.shape
    U = _orth(sR)

    ZU = (zmul_head if zmul_head is not None else zmul_mat)(U)     # (3n, o)
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
    lam_perp_lb = lam_perp - resid
    if eta is not None:
        lam_perp_lb = lam_perp_lb - eta
    lam_min_est = torch.minimum(lam_U, lam_perp)
    lam_min_lb = torch.minimum(lam_U, lam_perp_lb) - b_norm
    v = v_perp if bool(lam_perp < lam_U) else v_U
    if with_parts:
        return lam_min_est, lam_min_lb, v, lam_U, b_norm
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


# ----------------------------------------------------------------------
# The matvec flow (implicit operators)
# ----------------------------------------------------------------------

def _implicit_z_build(Q_op, sR, lam):
    """The exact dual solve (driven by ONE exact apply ``B = Z0 sR``) and a
    factory of Z-matvec closures.  Returns ``(mk_zmul, dual, Dall, corr)``
    with ``mk_zmul(op)`` a closure ``(3n, k) -> Z @ X`` applying ``Z = C_op
    + lam-corr - A^*(y)`` through ``op``; the multiplier always comes from
    the exact ``Q_op``."""
    three_n, o = sR.shape
    n = three_n // 3
    lam = float(lam)
    S = sR.reshape(n, 3, o)
    x_ii = torch.sum(S[:, 0, :] ** 2, dim=-1)
    corr = 2.0 * lam * (x_ii - 1.0)              # added to rows/cols (3i, 3i)

    def zmul0(op, X):                             # (3n, k) -> Z X without A*(y)
        out = op.apply(X)
        Xb = X.reshape(n, 3, -1)
        add = torch.zeros_like(Xb)
        add[:, 0, :] = corr[:, None] * Xb[:, 0, :]
        return out + add.reshape(3 * n, -1)

    y0, Dall = _dual_blocks(S, zmul0(Q_op, sR).reshape(n, 3, o))

    def mk_zmul(op):
        def zmul_mat(X):
            Xb = X.reshape(n, 3, -1)
            return zmul0(op, X) - torch.einsum("nab,nbk->nak", Dall,
                                               Xb).reshape(3 * n, -1)
        return zmul_mat

    dual = y0[0] + y0[3] + y0[5] + lam * torch.sum(1.0 - x_ii ** 2)
    return mk_zmul, dual, Dall, corr


def _delta_min(Dall, corr):
    """``min_i lam_min(Delta_i)`` of ``Z = C + blkdiag(Delta)``: a rigorous
    lower bound on ``lam_min(Z)`` when ``C`` is structurally PSD."""
    Delta = -Dall.clone()
    Delta[:, 0, 0] += corr
    Delta = 0.5 * (Delta + Delta.transpose(-1, -2))
    return torch.min(torch.linalg.eigh(Delta)[0])


def _implicit_z_parts(Q_op, sR, lam, with_diag: bool = False,
                      with_delta: bool = False, apply_op=None):
    """``(zmul_mat, dual)`` of the implicit certificate, plus the Delta
    bound (``with_delta``) or the approximate per-camera diagonal blocks of
    Z (``with_diag``: ``Q_op.diag_blocks()`` + lam-corr - A^*(y), for
    preconditioning only).  ``apply_op``: a fast approximate operator used
    in the returned CLOSURE only."""
    mk_zmul, dual, Dall, corr = _implicit_z_build(Q_op, sR, lam)
    zmul_mat = mk_zmul(apply_op if apply_op is not None else Q_op)
    if with_delta:
        return zmul_mat, dual, _delta_min(Dall, corr)
    if with_diag:
        Zdiag = Q_op.diag_blocks() - Dall
        Zdiag[:, 0, 0] += corr
        return zmul_mat, dual, Zdiag
    return zmul_mat, dual


def _certify_core_matvec(Q_op, sR, lam, primal, v0=None,
                         lanczos_iters: int = 48, Q_fast=None, eta=0.0):
    """Matvec-only certificate core: the deflated two-block bound (Krylov
    iterations through ``Q_fast`` when given, widened by ``eta``; the head,
    coupling norm, dual and Delta bound exact).  Returns host ``(lam_min,
    v, gap, dual, lam_min - lam_min_lb, lam_U, delta_min)``."""
    mk_zmul, dual, Dall, corr = _implicit_z_build(Q_op, sR, lam)
    zmul_mat = mk_zmul(Q_op)
    zmul_fast = mk_zmul(Q_fast) if Q_fast is not None else zmul_mat
    delta_min = _delta_min(Dall, corr)
    n = sR.shape[0] // 3
    lam_min, lam_min_lb, v, lam_U, _b_norm = _deflated_min_eig(
        zmul_fast, sR, v0=v0, with_parts=True, num_iters=lanczos_iters,
        zmul_head=zmul_mat, eta=eta if Q_fast is not None else None)
    lam_min, lam_min_lb, lam_U, delta_min, dual = (float(x) for x in torch.stack(
        [lam_min, lam_min_lb, lam_U, delta_min, dual]).tolist())
    # gap through the rigorous lower bound (the tighter of the Lanczos
    # two-block bound and, for structurally PSD C, the Delta bound)
    if getattr(Q_op, "psd_by_construction", False):
        lam_min_lb = max(lam_min_lb, delta_min)
    gap = float(primal) - dual - 3.0 * n * min(0.0, lam_min_lb)
    return lam_min, v, gap, dual, lam_min - lam_min_lb, lam_U, delta_min


class ProbeResult(NamedTuple):
    """Outcome of the CG shift probe: ``accept`` only for a CONVERGED clean
    pass with at least ``min_explore`` explored directions; ``refuted``
    with a sound negative-curvature witness ``wdir``; neither means
    inconclusive."""

    accept: bool
    refuted: bool
    converged: bool
    iters: int
    wdir: torch.Tensor


class _ProbeCarry(NamedTuple):
    x: torch.Tensor
    r: torch.Tensor
    p: torch.Tensor
    rr: float          # <r, r> (true residual; stopping test)
    rz: float          # <r, M^-1 r> (PCG recurrence)
    bb: float          # <b, b> of the start vector (stopping scale)
    it: int
    neg: bool          # negative curvature seen
    wdir: torch.Tensor  # witness direction when neg
    Pbuf: "torch.Tensor | None"  # (3n, K) first K normalized directions


def _probe_operators(Q_op, A_op, sR, lam, shift, W=None, AW=None,
                     Einv=None):
    """``(amul, precond)`` of the CG shift probe: ``amul(x) = (Z + shift I)
    x`` through ``A_op`` (the dual multiplier from the exact ``Q_op``), and
    the SPD-floored block-Jacobi preconditioner — under the BNN deflation
    ``M2^-1 = P' Mj^-1 P + W E^-1 W'``, ``P = I - (AW) E^-1 W'``, when a
    deflation basis ``(W, AW, E^-1)`` is given.  The bodies of the
    reference's ``_psd_probe_chunk`` / ``_psd_probe_chunk_defl``, built
    once per probe instead of once per chunk (same numbers)."""
    three_n = sR.shape[0]
    n = three_n // 3
    zmul_mat, _, Zdiag = _implicit_z_parts(Q_op, sR, lam, with_diag=True,
                                           apply_op=A_op)
    Ms = Zdiag + shift * torch.eye(3, dtype=sR.dtype, device=sR.device)
    wM, VM = torch.linalg.eigh(Ms)
    floor = 1e-6 * torch.clamp(torch.max(torch.abs(wM)), min=1e-30)
    wM = torch.maximum(wM, floor)
    Minv = torch.einsum("nak,nk,nbk->nab", VM, 1.0 / wM, VM)

    def jacobi(r):
        return torch.einsum("nab,nb->na", Minv, r.reshape(n, 3)).reshape(
            three_n)

    precond = jacobi
    if W is not None:
        def precond(r):
            pr = r - AW @ (Einv @ (W.T @ r))          # P r
            z = jacobi(pr)
            z = z - W @ (Einv @ (AW.T @ z))           # P' z
            return z + W @ (Einv @ (W.T @ r))         # + Q r

    def amul(x):
        return zmul_mat(x[:, None])[:, 0] + shift * x

    return amul, precond


def _psd_probe_chunk(amul, precond, b, carry, kmax: int,
                     verify_k: int = 0) -> _ProbeCarry:
    """One bounded chunk of the preconditioned CG shift probe: iterations
    until ``it == kmax``, negative curvature, or ``rr <= 1e-24 bb``.
    ``carry`` None starts the pass from ``b``; ``verify_k > 0`` stores the
    first ``verify_k`` normalized search directions (fast-operator probe)."""
    if carry is None:
        z0 = precond(b)
        bb, rz = (float(v) for v in torch.stack(
            [torch.dot(b, b), torch.dot(b, z0)]).tolist())
        Pbuf = (torch.zeros((b.shape[0], verify_k), dtype=b.dtype,
                            device=b.device) if verify_k else None)
        carry = _ProbeCarry(torch.zeros_like(b), b, z0, bb, rz, bb, 0, False,
                            torch.zeros_like(b), Pbuf)
    x, r, p, rr, rz, bb, it, neg, wdir, Pbuf = carry
    while it < kmax and not neg and rr > 1e-24 * bb:
        if Pbuf is not None and it < Pbuf.shape[1]:
            Pbuf[:, it] = p * torch.rsqrt(torch.clamp(torch.dot(p, p),
                                                      min=1e-300))
        Ap = amul(p)
        pAp = float(torch.dot(p, Ap))
        it += 1
        if pAp <= 0.0:
            # sound witness: p' (Z + shift I) p <= 0
            neg, wdir = True, p
            break
        alpha = rz / pAp
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rr_new, rz_new = (float(v) for v in torch.stack(
            [torch.dot(r, r), torch.dot(r, z)]).tolist())
        with np.errstate(all="ignore"):
            beta = np.float64(rz_new) / np.float64(rz)
        p = z + float(beta) * p
        rr, rz = rr_new, rz_new
    return _ProbeCarry(x, r, p, rr, rz, bb, it, neg, wdir, Pbuf)


def _probe_subspace_verify(Q_op, sR, lam, shift, P):
    """Exact check of the fast probe's stored directions ``P (3n, k)``:
    ``lam_min(H)`` of ``H = P' (Z_exact + shift I) P`` (one wide exact
    apply) and the witness ``w = P c`` of its lowest eigenvector.  Returns
    host ``(lam_min_H, w, ||w||)``."""
    if P.shape[1] == 0:
        # nothing stored: the reference's fully masked H is the identity
        return 1.0, torch.zeros_like(sR[:, 0]), 0.0
    mk_zmul, _, _, _ = _implicit_z_build(Q_op, sR, lam)
    AP = mk_zmul(Q_op)(P) + shift * P
    H = P.T @ AP
    H = 0.5 * (H + H.T)
    wH, VH = torch.linalg.eigh(H)
    w = P @ VH[:, 0]
    return float(wH[0]), w, float(torch.linalg.norm(w))


def _exact_probe_curvature(Q_op, sR, lam, shift, w) -> float:
    """Exact shifted Rayleigh quotient ``w'(Z + shift I)w / w'w`` (one exact
    matvec); re-checks a fast-operator negative-curvature witness."""
    mk_zmul, _, _, _ = _implicit_z_build(Q_op, sR, lam)
    Aw = mk_zmul(Q_op)(w[:, None])[:, 0] + shift * w
    return float(torch.dot(w, Aw) / torch.clamp(torch.dot(w, w), min=1e-300))


def _probe_deflation_basis(Q_op, sR, lam, shift, v0):
    """Orthonormal ``W = orth([sR | v0])`` (3n, o+1), ``AW = (Z + shift I)
    W`` and ``E = W' A W``.  A ``v0`` (numerically) inside span(sR), or
    absent, is replaced by a fixed random direction (a CPU
    ``torch.Generator`` seeded with 11)."""
    three_n, o = sR.shape
    if v0 is None:
        v0 = torch.zeros((three_n,), dtype=sR.dtype, device=sR.device)
    U = _orth(sR)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(11)
    rnd = torch.randn((three_n,), generator=gen, dtype=sR.dtype).to(
        sR.device)
    w = v0 - U @ (U.T @ v0)
    nw = float(torch.linalg.norm(w))
    if nw > 1e-8 * max(float(torch.linalg.norm(v0)), 1.0):
        w = w / max(nw, 1e-30)
    else:
        alt = rnd - U @ (U.T @ rnd)
        w = alt / torch.linalg.norm(alt)
    Wn = torch.cat([U, w[:, None]], dim=1)
    zmul_mat, _ = _implicit_z_parts(Q_op, sR, lam)
    AW = zmul_mat(Wn) + shift * Wn
    E = Wn.T @ AW
    return Wn, AW, 0.5 * (E + E.T)


def _implicit_psd_probe(Q_op, sR, lam, shift, max_iters: "int | None" = None,
                        v0=None, has_v0: bool = False, chunk: int = 64,
                        min_explore: int = 32, deflate: bool = True,
                        max_seconds: "float | None" = 900.0,
                        Q_fast=None, verify_k: int = 48) -> ProbeResult:
    """CG shift probe: decides ``lam_min(Z) > -shift`` through the factored
    operator (see the reference for the argument).  Negative curvature is a
    sound refutation; acceptance needs a converged clean pass with at least
    ``min_explore`` explored directions (fresh random starts make up the
    count); a budget- or clock-exhausted pass is inconclusive.  With
    ``Q_fast`` the iterations run through it, a fast witness is re-checked
    exactly, and a converged pass is accepted only after the exact check of
    its first ``verify_k`` stored directions."""
    three_n, o = sR.shape
    shift = float(shift)
    if max_iters is None:
        max_iters = int(max(512, 1.1 * three_n + 64))
    deadline = (float("inf") if max_seconds is None
                else time.monotonic() + max_seconds)

    W = AW = Einv = None
    if deflate:
        W, AW, E = _probe_deflation_basis(Q_op, sR, lam, shift,
                                          v0 if has_v0 else None)
        wE, VE = np.linalg.eigh(E.cpu().numpy())
        if wE[0] <= 0.0:
            # exact small-block indefiniteness: sound witness, no CG needed
            wdir = W @ torch.as_tensor(VE[:, 0], device=sR.device)
            return ProbeResult(False, True, False, int(o) + 1, wdir)
        Einv = torch.as_tensor(VE @ ((1.0 / wE)[:, None] * VE.T),
                               dtype=sR.dtype, device=sR.device)

    def start_vec(probe_idx: int):
        if probe_idx == 0 and has_v0 and v0 is not None and not deflate:
            return v0 / torch.linalg.norm(v0)
        rng = np.random.default_rng(7 + probe_idx)
        b = rng.standard_normal(three_n)
        return torch.as_tensor(b / np.linalg.norm(b), dtype=sR.dtype,
                               device=sR.device)

    A_op = Q_fast if Q_fast is not None else Q_op
    amul, precond = _probe_operators(Q_op, A_op, sR, lam, shift, W, AW, Einv)

    def rerun_exact():
        # fast-op evidence did not survive the exact re-check: decide on
        # the exact operator from scratch
        return _implicit_psd_probe(
            Q_op, sR, lam, shift, max_iters=max_iters, v0=v0, has_v0=has_v0,
            chunk=chunk, min_explore=min_explore, deflate=deflate,
            max_seconds=max_seconds, Q_fast=None, verify_k=verify_k)

    total = 0
    probe_idx = 0
    while True:
        b = start_vec(probe_idx)
        carry = None
        it = 0
        budget = min(max_iters - total, max_iters)
        converged = False
        neg = False
        while it < budget:
            prev_it = it
            carry = _psd_probe_chunk(amul, precond, b, carry,
                                     min(it + chunk, budget),
                                     verify_k if Q_fast is not None else 0)
            it, neg, rr, bb = carry.it, carry.neg, carry.rr, carry.bb
            converged = rr <= 1e-24 * bb
            if neg or converged:
                break
            if it <= prev_it and prev_it > 0 or not np.isfinite(rr):
                # a NaN breakdown ends the pass without advancing: the
                # inconclusive return below
                break
            if time.monotonic() > deadline:
                break
        total += it
        if neg:
            if Q_fast is not None:
                curv = _exact_probe_curvature(Q_op, sR, lam, shift,
                                              carry.wdir)
                if not curv <= 0.0:
                    return rerun_exact()
            return ProbeResult(False, True, converged, total, carry.wdir)
        if not converged:
            return ProbeResult(False, False, False, total, carry.wdir)
        if Q_fast is not None:
            # exact-subspace verification of the stored directions: the
            # acceptance never rests on the fast operator
            lamH, wvec, wn = _probe_subspace_verify(
                Q_op, sR, lam, shift, carry.Pbuf[:, :min(it, verify_k)])
            if not lamH > 0.0:
                if np.isfinite(lamH) and wn > 1e-150:
                    return ProbeResult(False, True, True, total, wvec / wn)
                return rerun_exact()
        if total >= min_explore:
            return ProbeResult(True, False, True, total, carry.wdir)
        if total >= max_iters:
            # converged under the evidence floor with the budget spent:
            # inconclusive, never accept
            return ProbeResult(False, False, True, total, carry.wdir)
        probe_idx += 1  # converged early: explore more from a fresh start


def _matvec_cert_flow(Q, sR, lam, primal, bound, v0, verbose, Q_fast=None):
    """Matvec-only certificate decision flow: deflated two-block Lanczos
    bound + structural Delta bound, with the convergence-gated CG shift
    probe as the decider.  Returns ``(certified, v, lam_min, gap, dual,
    conclusive, info)`` (host scalars; ``info`` records the deciding branch
    as in the reference)."""
    n = sR.shape[0] // 3
    eta_m = 0.0
    if Q_fast is not None:
        # as the reference: the fast Krylov lower bound is invalidated
        # outright (no measured operator-error bound is passed), so the
        # decision rests on the exact Delta bound or the exactly verified
        # probe
        eta_m = 1e30
    # every Lanczos iteration is an operator apply; the probe decides when
    # the bound is inconclusive, so the prelude is short at scale
    lanczos_iters = 48 if sR.shape[0] <= 4096 else 24
    lam_min, v, gap, dual, resid, _lam_U, delta_min = _certify_core_matvec(
        Q, sR, lam, primal, v0=v0, lanczos_iters=lanczos_iters,
        Q_fast=Q_fast, eta=eta_m)
    primal = float(primal)
    by_gap = gap / primal < 1e-3
    by_bound = lam_min - resid > -bound
    certified = by_gap or by_bound
    delta_decisive = bool(certified and not by_gap
                          and getattr(Q, "psd_by_construction", False)
                          and delta_min > -bound)
    info = {"path": "gap" if by_gap else ("bound" if by_bound
                                          else "inconclusive"),
            "delta_bound_decisive": delta_decisive, "probe_iters": 0}
    conclusive = True
    if not certified and lam_min > -bound:
        # the Ritz estimate is inside the acceptance region but the
        # cluster-limited lower bound is not: CG shift probe of the full Z
        # at shift = bound, started from the lowest Ritz direction
        pr = _implicit_psd_probe(Q, sR, lam, bound, v0=v, has_v0=True,
                                 Q_fast=Q_fast)
        info["probe_iters"] = pr.iters
        if pr.accept:
            certified = True
            info["path"] = "probe"
            gap = primal - dual + 3.0 * n * bound
        elif pr.refuted:
            info["path"] = "probe_refuted"
            v = pr.wdir / torch.linalg.norm(pr.wdir)
        else:
            conclusive = False
            if verbose:
                print(f"[certify] shift probe inconclusive after "
                      f"{pr.iters} matvecs (no convergence, no negative "
                      f"curvature)")
    return certified, v, lam_min, gap, dual, conclusive, info


def certify(C, sR, lam, primal, verbose: bool = False,
            method: str = "auto", v0=None, fast=None,
            device=None) -> CertificateResult:
    """Check global optimality of the rank-o point ``sR``.

    ``C``: a dense cost matrix / ``DenseQ`` ("auto" = the Cholesky probe,
    or "eigh" / "lanczos"), or an implicit operator (the matvec flow).
    ``v0``: optional Lanczos start vector.  ``fast``: an optional fast
    approximate operator of the same cost (``SchurQ.two_float()``) for the
    implicit flow's per-iteration matvecs, decisions exact-anchored;
    ``"auto"`` derives none (the reference's CPU branch, on both devices).
    ``device``: None = the CUDA card, ``"cpu"`` for the host."""
    dev = resolve_device(device)
    Q = as_qop(C, device=dev)
    if fast == "auto":
        fast = None
    sR = torch.as_tensor(sR, dtype=torch.float64, device=dev)
    if v0 is not None:
        v0 = torch.as_tensor(v0, dtype=torch.float64, device=dev)
    n = sR.shape[0] // 3
    primal = float(primal)
    bound = _min_eig_bound(n)
    info = None

    if not isinstance(Q, DenseQ):
        certified, v, lam_min, gap, dual, _conclusive, info = (
            _matvec_cert_flow(Q, sR, lam, primal, bound, v0, verbose,
                              Q_fast=(None if fast is None
                                      else as_qop(fast, device=dev))))
    elif method == "auto":
        Cm = Q.C.to(torch.float64)
        Z, dual, psd, lme, lmlb, v_inv = _build_z_dual_psd(Cm, sR, lam, bound)
        certified, v, lam_min, gap, dual = finish_auto_certificate(
            Z, n, bound, primal, dual, psd, lme, lmlb, v_inv, v0=v0)
    else:
        lam_min, v, gap, dual, resid = _certify_core(
            Q.C.to(torch.float64), sR, lam, primal, v0=v0,
            use_lanczos=method == "lanczos")
        # the Lanczos Ritz value only bounds lam_min from above
        certified = (gap / primal < 1e-3) or (lam_min - resid > -bound)
    if verbose:
        print(f"[certify] primal={primal:.6e} dual={dual:.6e} "
              f"gap={gap:.3e} lam_min={lam_min:.3e} "
              f"certified={bool(certified)}")
    return CertificateResult(bool(certified), v, float(lam_min), float(gap),
                             float(dual), primal, info)
