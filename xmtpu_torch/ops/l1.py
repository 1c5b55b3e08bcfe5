"""L1-norm least-deviations solver: ADMM with matrix-free CG inner solves.

PyTorch counterpart of ``xmtpu/ops/l1.py`` (the GLOMAP fork's Theia/Boyd
L1 solver, deps/glomap/glomap/math/l1_solver.h): minimize
``|| A x - b ||_1`` by ADMM —

    x^{k+1} = argmin_x ||A x - (b + z - u)||_2     (normal equations)
    z^{k+1} = shrink(alpha A x + (1-alpha)(z+b) - b + u, 1/rho)
    u^{k+1} = u + (ax_hat - z - b)

with the x-update a matrix-free conjugate-gradient solve over the
caller's ``A_mul``/``At_mul``.  The reference runs the ADMM as one
``lax.while_loop`` around a ``fori_loop`` CG; here the CG's fixed
``cg_iters`` iterations run with no host read (the reference's ``live``
guard is a ``torch.where``), and the ADMM loop reads its stop flag back
once per iteration, where the ``while_loop`` condition stood.
"""

from __future__ import annotations

import math

import torch

from xmtpu_torch._device import resolve_device


def _leaves(tree):
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in _leaves(t)]
    return [tree]


def _map(fn, *trees):
    if isinstance(trees[0], (tuple, list)):
        return type(trees[0])(_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def _shrinkage(v, kappa):
    """Soft-threshold (l1_solver.h:105-112)."""
    return (torch.clamp_min(v - kappa, 0.0)
            - torch.clamp_min(-v - kappa, 0.0))


def _tree_vdot(a, b):
    return sum(torch.dot(x.reshape(-1), y.reshape(-1))
               for x, y in zip(_leaves(a), _leaves(b)))


def _tree_axpy(alpha, x, y):
    return _map(lambda a, b: alpha * a + b, x, y)


def _tree_norm(a):
    return torch.sqrt(_tree_vdot(a, a))


def make_l1_admm(A_mul, At_mul, n_rows: int, n_cols: int,
                 rho: float = 1.0, alpha: float = 1.0,
                 absolute_tolerance: float = 1e-4,
                 relative_tolerance: float = 1e-2,
                 cg_iters: int = 50):
    """Build an L1 solver ``solve(b, x0, max_iters) -> x``.

    ``A_mul(x)`` and ``At_mul(y)`` may consume/produce tensors or tuples of
    tensors (``x`` in the column space, ``y`` in the row space); ``n_rows``
    / ``n_cols`` are the total element counts used by the tolerance scaling
    (l1_solver.h:50-54).  Options mirror ``L1SolverOptions``
    (l1_solver.h:19-28).  ``solve`` runs on the inputs' device and reads
    one flag back per ADMM iteration.
    """

    def cg_solve(rhs, x0):
        """CG on the SPD normal operator x -> At(A x), ``cg_iters`` steps."""

        def AtA(x):
            return At_mul(A_mul(x))

        r = _tree_axpy(-1.0, AtA(x0), rhs)
        x, p, rs = x0, r, _tree_vdot(r, r)
        for _ in range(cg_iters):
            live = rs > 1e-30
            Ap = AtA(p)
            pAp = _tree_vdot(p, Ap)
            a = torch.where(live, rs / torch.where(pAp == 0, 1.0, pAp), 0.0)
            x = _tree_axpy(a, p, x)
            r = _tree_axpy(-a, Ap, r)
            rs_new = _tree_vdot(r, r)
            beta = torch.where(live, rs_new / rs, 0.0)
            p = _tree_axpy(beta, p, r)
            rs = rs_new
        return x

    primal_abs_eps = math.sqrt(float(n_rows)) * absolute_tolerance
    dual_abs_eps = math.sqrt(float(n_cols)) * absolute_tolerance

    def solve(b, x0, max_iters: int):
        rhs_norm = _tree_norm(b)
        z = u = _map(torch.zeros_like, b)
        x, k = x0, 0
        while k < max_iters:
            # x-update: AtA x = At(b + z - u)
            rhs = At_mul(_map(lambda bb, zz, uu: bb + zz - uu, b, z, u))
            x = cg_solve(rhs, x)
            ax = A_mul(x)
            ax_hat = _map(
                lambda a_, z_, b_: alpha * a_ + (1.0 - alpha) * (z_ + b_),
                ax, z, b)
            z_old = z
            z = _map(lambda ah, b_, u_: _shrinkage(ah - b_ + u_, 1.0 / rho),
                     ax_hat, b, u)
            u = _map(lambda u_, ah, z_, b_: u_ + ah - z_ - b_,
                     u, ax_hat, z, b)

            # convergence (l1_solver.h:75-92)
            r_norm = _tree_norm(_map(lambda a_, z_, b_: a_ - z_ - b_,
                                     ax, z, b))
            s_norm = rho * _tree_norm(At_mul(_map(lambda zn, zo: zn - zo,
                                                  z, z_old)))
            max_norm = torch.maximum(torch.maximum(_tree_norm(ax),
                                                   _tree_norm(z)), rhs_norm)
            primal_eps = primal_abs_eps + relative_tolerance * max_norm
            dual_eps = (dual_abs_eps + relative_tolerance
                        * rho * _tree_norm(At_mul(u)))
            done = (r_norm < primal_eps) & (s_norm < dual_eps)
            k += 1
            if bool(done):
                break
        return x

    return solve


def l1_solve_dense(A, b, max_iters: int = 1000, device=None, **kw):
    """Dense-matrix form of :func:`make_l1_admm` (the template-instantiation
    analog of ``L1Solver<Eigen::MatrixXd>``) on ``device`` (None = the CUDA
    card).  Returns ``x`` as a tensor on that device."""
    dev = resolve_device(device)
    A = torch.as_tensor(A, device=dev)
    solve = make_l1_admm(lambda x: A @ x, lambda y: A.T @ y,
                         A.shape[0], A.shape[1], **kw)
    x0 = torch.zeros(A.shape[1], dtype=A.dtype, device=dev)
    return solve(torch.as_tensor(b, dtype=A.dtype, device=dev), x0,
                 max_iters)
