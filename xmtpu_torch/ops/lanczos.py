"""Lanczos extreme-eigenpair solver for the dual certificate.

PyTorch counterpart of ``xmtpu/ops/lanczos.py``: Lanczos with full (two-pass)
reorthogonalization, then an eigendecomposition of the small tridiagonal.
The Krylov loop is a host loop over device tensors.

The reference draws its default start vector from ``jax.random``, whose bits
cannot be reproduced here.  The port draws it from a CPU ``torch.Generator``
seeded with ``seed`` and moves it to the device, so the same seed gives the
same start vector on the host and on the card.  Tests that compare the two
packages pass the same ``v0`` to both.
"""

from __future__ import annotations

import torch


def start_vector(dim: int, seed: int = 0, device=None) -> torch.Tensor:
    """The default (dim,) f64 start vector for ``seed``."""
    gen = torch.Generator(device="cpu")
    gen.manual_seed(seed)
    return torch.randn((dim,), generator=gen, dtype=torch.float64).to(device)


def lanczos_min_eig(matvec, dim: int, num_iters: int = 96, seed: int = 0,
                    v0=None, device=None):
    """Smallest eigenpair of a symmetric operator.

    Args:
      matvec: ``x (dim,) -> A x (dim,)`` (float64).
      num_iters: Krylov dimension (clamped to ``dim``).
      v0: optional start vector (e.g. the previous escape direction); its
        device sets the device of the solve.
      device: device of the default start vector when ``v0`` is None.

    Returns ``(lam_min, v, resid)`` where ``resid = ||A v - lam v||``.
    """
    k = min(num_iters, dim)
    if v0 is None:
        v0 = start_vector(dim, seed, device)
    v0 = v0.to(torch.float64)
    v0 = v0 / torch.linalg.norm(v0)
    dev = v0.device

    V = torch.zeros((k + 1, dim), dtype=torch.float64, device=dev)
    V[0] = v0
    alphas = torch.zeros((k,), dtype=torch.float64, device=dev)
    betas = torch.zeros((k,), dtype=torch.float64, device=dev)
    zero = torch.zeros((), dtype=torch.float64, device=dev)

    for j in range(k):
        v = V[j]
        w = matvec(v)
        alpha = torch.dot(v, w)
        w = w - alpha * v - (betas[j - 1] if j > 0 else zero) * V[j - 1]
        # full reorthogonalization against the basis so far (two passes);
        # rows past j are still zero, as in the reference's masked form
        Vj = V[:j + 1]
        for _ in range(2):
            w = w - Vj.T @ (Vj @ w)
        beta = torch.linalg.norm(w)
        # beta underflow (invariant subspace): the next direction is zero
        w = torch.where(beta > 1e-14, w / torch.clamp(beta, min=1e-300),
                        torch.zeros_like(w))
        V[j + 1] = w
        alphas[j] = alpha
        betas[j] = beta

    T = (torch.diag(alphas) + torch.diag(betas[:-1], 1)
         + torch.diag(betas[:-1], -1))
    w_T, y_T = torch.linalg.eigh(T)
    lam = w_T[0]
    v = V[:k].T @ y_T[:, 0]
    v = v / torch.linalg.norm(v)
    resid = torch.linalg.norm(matvec(v) - lam * v)
    return lam, v, resid


def lanczos_min_eig_dense(A: torch.Tensor, num_iters: int = 96,
                          seed: int = 0):
    """Convenience wrapper for a dense symmetric matrix."""
    return lanczos_min_eig(lambda x: A @ x, A.shape[0], num_iters, seed,
                           device=A.device)
