"""Product-manifold primitives for the XM Burer-Monteiro factorization.

PyTorch counterpart of ``xmtpu/ops/manifold.py`` (same names, same
conventions, same formulas).  The search space is

    M = (St_row(3, o))^n  x  R_{>0}^{n-1}

with ``R_i R_i^T = I_3`` per camera and camera 0's scale pinned to 1.  The
metric is Frobenius on the frames and ``g_s(u, v) = sum_i u_i v_i / s_i^2`` on
the free scales.

Conventions
-----------
* ``R``  : (n, 3, o) tensor — per-camera frames, orthonormal rows.
* ``s_ex``: (n,) with ``s_ex[0] == 1`` pinned; free scales are ``s = s_ex[1:]``.
* Tangent vectors use the same shapes; scale tangents are length ``n-1``.
* "flat" layout (3n, o) = ``R.reshape(3n, o)`` interoperates with the Q matrix.

The scale-Hessian sign follows the reference's *code* (``+``), not its
MATLAB comment: see the module docstring of ``xmtpu/ops/manifold.py``.

Every function is a plain tensor function: device and dtype follow the
inputs.  The per-camera 3x3 contractions use the broadcast-multiply-reduce
("elem") form, the reference's default.
"""

from __future__ import annotations

import torch


def gram3(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Per-camera row-Gram ``S[i] = A_i B_i^T``: (n,3,o)x(n,3,o) -> (n,3,3)."""
    return (A[:, :, None, :] * B[:, None, :, :]).sum(-1)


def apply3(S: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """Per-camera block apply ``S_i R_i``: (n,3,3)x(n,3,o) -> (n,3,o)."""
    return (S[:, :, :, None] * R[:, None, :, :]).sum(2)


def flatten(R: torch.Tensor) -> torch.Tensor:
    """(n, 3, o) -> (3n, o)."""
    return R.reshape(3 * R.shape[0], R.shape[2])


def unflatten(Rf: torch.Tensor) -> torch.Tensor:
    """(3n, o) -> (n, 3, o)."""
    return Rf.reshape(Rf.shape[0] // 3, 3, Rf.shape[1])


def identity_frames(n: int, o: int, dtype=torch.float64,
                    device=None) -> torch.Tensor:
    """Rank-``o`` identity initialization: each frame is ``[I_3 | 0]``."""
    eye = torch.zeros((3, o), dtype=dtype, device=device)
    eye[:, :3] = torch.eye(3, dtype=dtype, device=device)
    return eye.expand(n, 3, o).clone()


def scale_blocks(R: torch.Tensor, s_ex: torch.Tensor) -> torch.Tensor:
    """Per-camera block scaling ``sR_i = s_i * R_i``."""
    return R * s_ex[:, None, None]


def block_dots(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Per-camera Frobenius dot ``<A_i, B_i>`` for i >= 1: (n-1,)."""
    return torch.einsum("nko,nko->n", A[1:], B[1:])


def sym3(M: torch.Tensor) -> torch.Tensor:
    """Batched 3x3 symmetrization ``(M + M^T)/2``."""
    return 0.5 * (M + M.transpose(-1, -2))


def vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Flattened dot product of two same-shape tensors (``jnp.vdot``)."""
    return torch.dot(a.reshape(-1), b.reshape(-1))


def inner(aR, bR, a_s, b_s, s) -> torch.Tensor:
    """Riemannian inner product: ``<aR, bR>_F + sum(a_s * b_s / s^2)``."""
    return vdot(aR, bR) + torch.sum(a_s * b_s / (s * s))


def project(R, s, gR, gs):
    """Tangent projection: ``pgR_i = gR_i - sym(R_i gR_i^T) R_i``;
    ``pgs = s^2 * gs``."""
    S = sym3(gram3(R, gR))
    pgR = gR - apply3(S, R)
    pgs = s * s * gs
    return pgR, pgs


def ehess2rhess(ehR, ehs, egR, egs, R, s, Ru, su, Segr=None):
    """Euclidean-to-Riemannian Hessian conversion.

    ``rhR_i = P_Ri( ehR_i - sym(R_i egR_i^T) Ru_i )``
    ``rhs   = ehs * s^2 + su * s * egs``   (the reference code's ``+`` sign)

    ``Segr`` optionally supplies the precomputed ``sym(R egR^T)``, constant
    across a tCG inner loop.
    """
    if Segr is None:
        Segr = sym3(gram3(R, egR))
    rhR = ehR - apply3(Segr, Ru)
    S2 = sym3(gram3(R, rhR))
    rhR = rhR - apply3(S2, R)
    rhs = ehs * s * s + su * s * egs
    return rhR, rhs


def mgs_rows(A: torch.Tensor) -> torch.Tensor:
    """Batched modified Gram-Schmidt of the 3 rows of each (3, o) block —
    the frame retraction's QR step (no sign fix, plain MGS)."""
    r0 = A[:, 0, :]
    r1 = A[:, 1, :]
    r2 = A[:, 2, :]
    r0 = r0 / torch.linalg.norm(r0, dim=-1, keepdim=True)
    r1 = r1 - torch.einsum("no,no->n", r0, r1)[:, None] * r0
    r2 = r2 - torch.einsum("no,no->n", r0, r2)[:, None] * r0
    r1 = r1 / torch.linalg.norm(r1, dim=-1, keepdim=True)
    r2 = r2 - torch.einsum("no,no->n", r1, r2)[:, None] * r1
    r2 = r2 / torch.linalg.norm(r2, dim=-1, keepdim=True)
    return torch.stack([r0, r1, r2], dim=1)


def retract(R, s_ex, vR, vs, lr):
    """Product-manifold retraction: ``R_new = mgs_rows(R + lr vR)``,
    ``s_new = s exp(lr vs / s)`` on the free scales (camera 0 pinned)."""
    R_new = mgs_rows(R + lr * vR)
    s = s_ex[1:]
    s_new = s * torch.exp(lr * vs / s)
    return R_new, torch.cat([s_ex[:1], s_new])


def objective(qmul, R, s_ex, lam) -> torch.Tensor:
    """``f = <sR, Q sR> + lam * sum((s_i^2 - 1)^2)``; ``qmul`` maps a flat
    (3n, o) tensor to ``Q @ Y``."""
    sR = flatten(scale_blocks(R, s_ex))
    s = s_ex[1:]
    return vdot(sR, qmul(sR)) + lam * torch.sum((s * s - 1.0) ** 2)


def objective_from_sR(qmul, sR_flat, s_ex, lam) -> torch.Tensor:
    s = s_ex[1:]
    return vdot(sR_flat, qmul(sR_flat)) + lam * torch.sum((s * s - 1.0) ** 2)


def egrad(qmul, R, s_ex, lam):
    """Euclidean gradient: ``gR = 2 Q sR .* s_ex``;
    ``gs_i = <2 Q sR_i, R_i> + 4 lam (s_i^2 - 1) s_i`` (i >= 1)."""
    gR, gs, _ = egrad_csr(qmul, R, s_ex, lam)
    return gR, gs


def egrad_csr(qmul, R, s_ex, lam):
    """``egrad`` that also returns ``CsR = 2 Q sR`` (n, 3, o)."""
    sR = flatten(scale_blocks(R, s_ex))
    dfdsR = unflatten(2.0 * qmul(sR))
    gR, gs = egrad_from_csr(dfdsR, R, s_ex, lam)
    return gR, gs, dfdsR


def egrad_from_csr(dfdsR, R, s_ex, lam):
    """Euclidean gradient from an already-computed ``dfdsR = 2 Q sR``."""
    gR = scale_blocks(dfdsR, s_ex)
    s = s_ex[1:]
    gs = block_dots(dfdsR, R) + 4.0 * lam * (s * s - 1.0) * s
    return gR, gs


def ehess(qmul, R, s_ex, CsR, Ru, su, lam):
    """Euclidean Hessian-vector product with the hoisted ``CsR = 2 Q sR``:
    ``W = Ru .* s_ex + R .* su_ex``; ``CW = 2 Q W``;
    ``hR = CsR .* su_ex + CW .* s_ex``;
    ``hs_i = <CW_i, R_i> + <CsR_i, Ru_i> + 4 lam (3 s_i^2 - 1) su_i``."""
    su_ex = torch.cat([torch.zeros((1,), dtype=su.dtype, device=su.device),
                       su])
    W = scale_blocks(Ru, s_ex) + scale_blocks(R, su_ex)
    CW = unflatten(2.0 * qmul(flatten(W)))
    hR = scale_blocks(CsR, su_ex) + scale_blocks(CW, s_ex)
    s = s_ex[1:]
    hs = (block_dots(CW, R) + block_dots(CsR, Ru)
          + 4.0 * lam * (3.0 * s * s - 1.0) * su)
    return hR, hs


def rhess(qmul, R, s_ex, CsR, egR, egs, Ru, su, lam, Segr=None):
    """Full Riemannian Hessian-vector product: ehess then ehess2rhess."""
    hR, hs = ehess(qmul, R, s_ex, CsR, Ru, su, lam)
    return ehess2rhess(hR, hs, egR, egs, R, s_ex[1:], Ru, su, Segr=Segr)


def random_tangent(generator: torch.Generator, R, s):
    """A random tangent vector at (R, s) — for property tests.  The normals
    are drawn on the host from ``generator`` and moved to ``R``'s device."""
    gR = torch.randn(R.shape, generator=generator, dtype=R.dtype)
    gs = torch.randn(s.shape, generator=generator, dtype=s.dtype)
    return project(R, s, gR.to(R.device), gs.to(s.device))
