"""Bundle-adjustment refinement: Levenberg-Marquardt on the reprojection cost.

PyTorch counterpart of ``xmtpu/pipeline/refine.py``, which replaces the
reference's Ceres bridge (``XM_Ceres_interface``, utils/ceresforXM.py:6-89):
SIMPLE_PINHOLE unit-camera reprojection residuals over pre-normalized 2-D
observations, one rotation manifold per camera, fixed intrinsics.

The same nonlinear least-squares problem, solved as the JAX package does:

* residual ``r_e = proj(expm(dw_f) R0_f (p0_l + dp_l) + t0_f + dt_f) - obs_e``
  with ``proj(x) = x[:2] / x[2]``; the unknowns ``(dw, dt, dp)`` accumulate
  across LM steps, and each step linearizes at the current values (through
  ``expm`` of the accumulated ``dw``), as ``jax.jvp``/``jax.vjp`` of the
  reference's residual do;
* the damped normal equations ``(J^T J + mu I) x = -J^T r`` are solved by a
  fixed ``cg_iters``-step CG without a preconditioner, its converged-residual
  guard a ``torch.where`` (no host read inside);
* ``mu`` starts at 1e-4, divided by 3 on an accepted step, doubled on a
  rejected one; the loop stops on an accepted step whose cost changed by
  less than 1e-12 relative.

The Jacobian is materialized per edge: one ``torch.func.vmap(jacfwd)`` of
the per-edge residual over edge-gathered values gives ``J_e`` (2 x 9, with
respect to ``(dw_f, dt_f, dp_l)``) once per LM step.  The unknowns are one
flat vector, so each CG update is one kernel.  ``J u`` is a gather and a
2 x 9 product per edge; ``J^T y`` sums the per-edge 9-vectors by frame
(D = 6) and by landmark (D = 3) through
:class:`xmtpu_torch.ops.segsum.Segments`, so on the card every sum runs
through ``sorted_segment_sum`` in a fixed order (no atomic scatter: the
same bits on every run).  The host reads one small tensor per LM step
(``cost``, ``cost_new``, ``accept``), counted in ``refine_bundle.host_reads``.

``only_landmarks=True`` zeroes the six camera columns (the reference's
mask, ceresforXM.py:56-58): the poses come back unchanged.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from xmtpu_torch._device import resolve_device
from xmtpu_torch.ops.segsum import Segments


def _hat(w):
    """(..., 3) -> (..., 3, 3) skew-symmetric."""
    zeros = torch.zeros_like(w[..., 0])
    return torch.stack([
        torch.stack([zeros, -w[..., 2], w[..., 1]], dim=-1),
        torch.stack([w[..., 2], zeros, -w[..., 0]], dim=-1),
        torch.stack([-w[..., 1], w[..., 0], zeros], dim=-1),
    ], dim=-2)


def _expm_so3(w):
    """Rodrigues: (..., 3) rotation vector -> (..., 3, 3).

    Written as ``I + A hat(w) + B hat(w)^2`` with A = sin(t)/t and
    B = (1-cos(t))/t^2, the small-angle series taken below t^2 = 1e-12 (the
    reference's branches, selected with ``torch.where`` on a safe argument
    so that the untaken branch never divides by zero).
    """
    t2 = torch.sum(w * w, dim=-1)[..., None, None]
    small = t2 < 1e-12
    t2s = torch.where(small, 1.0, t2)
    theta = torch.sqrt(t2s)
    A = torch.where(small, 1.0 - t2 / 6.0, torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(theta)) / t2s)
    K = _hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(K.shape)
    return eye + A * K + B * (K @ K)


class RefineResult(NamedTuple):
    R_est: np.ndarray   # (3, 3N) camera-to-world rotation blocks
    t_est: np.ndarray   # (3, N) camera centers
    p_est: np.ndarray   # (3, M) refined points
    iterations: int
    final_cost: float


def _edge_residual(d, R0, t0, p0, obs):
    """Residual (2,) of one observation at the accumulated unknowns
    ``d = (dw, dt, dp)`` (9,) of its frame and landmark."""
    R = _expm_so3(d[:3]) @ R0
    x = R @ (p0 + d[6:]) + t0 + d[3:6]
    return x[:2] / x[2] - obs


_edge_residual_batch = torch.func.vmap(_edge_residual)
_edge_jac_batch = torch.func.vmap(torch.func.jacfwd(_edge_residual))


class _Problem(NamedTuple):
    """The fixed data of one refinement on its device: the initial w2c
    poses and points, the observations, each edge's nine unknowns in the
    flat vector, and the sums by frame and by landmark.

    The unknowns live in one flat vector ``v`` of ``6N + 3M`` entries: the
    frames' ``(dw, dt)`` rows (N, 6), then the points' ``dp`` rows (M, 3),
    so each CG update is one kernel."""

    R0: torch.Tensor        # (N, 3, 3)
    t0: torch.Tensor        # (N, 3)
    p0: torch.Tensor        # (M, 3)
    obs: torch.Tensor       # (E, 2)
    f: torch.Tensor         # (E,) frame of each edge
    l: torch.Tensor         # (E,) landmark of each edge
    unknowns: torch.Tensor  # (E, 9) each edge's (dw, dt, dp) entries of v
    by_frame: Segments
    by_landmark: Segments
    cam_mask: bool          # False freezes the poses (only_landmarks)

    @classmethod
    def build(cls, R0, t0, p0, obs, f, l, cam_mask, device):
        """From host arrays: float64 poses and points, int64 edge ids."""
        N, M = len(R0), len(p0)
        unknowns = np.concatenate([6 * f[:, None] + np.arange(6),
                                   6 * N + 3 * l[:, None] + np.arange(3)],
                                  axis=1)

        def f64(a):
            return torch.as_tensor(np.ascontiguousarray(a, dtype=np.float64),
                                   device=device)

        return cls(f64(R0), f64(t0), f64(p0), f64(obs),
                   torch.as_tensor(f, device=device),
                   torch.as_tensor(l, device=device),
                   torch.as_tensor(unknowns, device=device),
                   Segments(f, N, device, "refine frame"),
                   Segments(l, M, device, "refine landmark"), cam_mask)

    def split(self, v):
        """Views of ``v``: the frames' (N, 6) rows and the points' (M, 3)."""
        N = self.R0.shape[0]
        return v[:6 * N].view(N, 6), v[6 * N:].view(-1, 3)

    def residuals(self, v):
        """(E, 2) residuals at the flat unknowns ``v``."""
        return _edge_residual_batch(v[self.unknowns], self.R0[self.f],
                                    self.t0[self.f], self.p0[self.l],
                                    self.obs)

    def jacobian(self, v):
        """The per-edge blocks at ``v``: (E, 2, 6) by the frame's unknowns
        (zero when the poses are frozen) and (E, 2, 3) by the point's."""
        J = _edge_jac_batch(v[self.unknowns], self.R0[self.f],
                            self.t0[self.f], self.p0[self.l], self.obs)
        Jc = (J[:, :, :6].contiguous() if self.cam_mask
              else torch.zeros_like(J[:, :, :6]))
        return Jc, J[:, :, 6:].contiguous()

    # the per-edge products are elementwise multiplies and sums: on the
    # H100 they took less device time than batched 2 x 6 GEMMs (cuBLAS's
    # gemv kernel) at the same number of launches

    def jt(self, J, y):
        """``J^T y`` for per-edge rows ``y`` (E, 2), flat: the camera part
        summed by frame, the point part by landmark."""
        Jc, Jp = J
        y = y[:, :, None]
        hc = self.by_frame.sum((Jc * y).sum(1))
        hp = self.by_landmark.sum((Jp * y).sum(1))
        return torch.cat([hc.reshape(-1), hp.reshape(-1)])

    def jtj(self, J, u, mu):
        """``(J^T J + mu I) u`` for a flat ``u``."""
        Jc, Jp = J
        uc, up = self.split(u)
        Ju = ((Jc * uc[self.f][:, None, :]).sum(2)
              + (Jp * up[self.l][:, None, :]).sum(2))
        return torch.add(self.jt(J, Ju), u, alpha=mu)


def _cost(r):
    return 0.5 * torch.sum(r * r)


def _lm_step(prob: _Problem, v, mu: float, cg_iters: int):
    """One LM step at ``v``: the CG solve of the damped normal equations
    and the trial point.  Returns ``(v_new, cost, cost_new)``."""
    r = prob.residuals(v)
    J = prob.jacobian(v)
    cost = _cost(r)
    g = prob.jt(J, r)

    x = torch.zeros_like(g)
    rr = -g
    pp = rr
    rs = torch.dot(rr, rr)
    for _ in range(cg_iters):
        # converged residual -> freeze (the fixed-count loop must not 0/0)
        live = rs > 1e-30
        Ap = prob.jtj(J, pp, mu)
        alpha = torch.where(live, rs / torch.dot(pp, Ap), 0.0)
        x = torch.addcmul(x, alpha, pp)
        rr = torch.addcmul(rr, alpha, Ap, value=-1.0)
        rs_new = torch.dot(rr, rr)
        beta = torch.where(live, rs_new / rs, 0.0)
        pp = torch.addcmul(rr, beta, pp)
        rs = rs_new

    v_new = v + x
    return v_new, cost, _cost(prob.residuals(v_new))


def refine_bundle(edges, landmarks2D, R_XM, t_XM, p_XM,
                  only_landmarks: bool = False, max_iters: int = 50,
                  cg_iters: int = 100, verbose: bool = False,
                  device=None) -> RefineResult:
    """LM refinement of (poses, points) from normalized 2-D observations,
    on ``device`` (None = the CUDA card; raises without one unless
    ``"cpu"``).

    Args match ``XM_Ceres_interface``: ``edges`` (E, 2) 1-based
    [frame, landmark]; ``landmarks2D`` (E, 2) *normalized* image coordinates;
    ``R_XM`` (3, 3N) c2w blocks, ``t_XM`` (3, N) camera centers, ``p_XM``
    (3, M) points (the XM solution as initial guess).  Inputs and outputs
    are numpy.
    """
    dev = resolve_device(device)
    edges = np.asarray(edges)
    N = int(edges[:, 0].max())
    M = int(edges[:, 1].max())
    f = edges[:, 0].astype(np.int64) - 1
    l = edges[:, 1].astype(np.int64) - 1

    # initial w2c pose: R_w2c = R_c2w^T, t_w2c = -R_c2w^T c
    Rb = np.asarray(R_XM, dtype=np.float64).reshape(3, N, 3).transpose(1, 0, 2)
    t0 = -np.einsum("nba,bn->na", Rb, np.asarray(t_XM, dtype=np.float64))

    prob = _Problem.build(Rb.transpose(0, 2, 1), t0,
                          np.asarray(p_XM, dtype=np.float64).T, landmarks2D,
                          f, l, not only_landmarks, dev)
    v = torch.zeros(6 * N + 3 * M, dtype=torch.float64, device=dev)
    mu = 1e-4
    it = 0
    for it in range(max_iters):
        v_new, cost, cost_new = _lm_step(prob, v, mu, cg_iters)
        cost, cost_new, accept = torch.stack(
            [cost, cost_new, (cost_new < cost).to(cost.dtype)]).tolist()
        refine_bundle.host_reads += 1
        accept = bool(accept)
        if accept:
            v = v_new
        mu = mu / 3.0 if accept else mu * 2.0
        if verbose:
            print(f"[refine] it={it} cost={cost:.6e} -> {cost_new:.6e} "
                  f"accept={accept} mu={mu:.1e}")
        if accept and abs(cost - cost_new) < 1e-12 * max(1.0, cost):
            break

    # the result in one device-to-host copy
    cam, pt = prob.split(v)
    R = _expm_so3(cam[:, :3]) @ prob.R0                 # w2c
    t = prob.t0 + cam[:, 3:]
    p = prob.p0 + pt
    flat = torch.cat([R.reshape(-1), t.reshape(-1), p.reshape(-1),
                      _cost(prob.residuals(v)).reshape(1)]).cpu().numpy()
    R = flat[:9 * N].reshape(N, 3, 3)
    t = flat[9 * N:12 * N].reshape(N, 3)
    p = flat[12 * N:12 * N + 3 * M].reshape(M, 3)

    R_c2w = R.transpose(0, 2, 1)
    centers = -np.einsum("nab,nb->na", R_c2w, t)
    return RefineResult(
        R_est=R_c2w.transpose(1, 0, 2).reshape(3, 3 * N),
        t_est=centers.T,
        p_est=p.T,
        iterations=it + 1,
        final_cost=float(flat[-1]),
    )


# host reads of the LM loop (one small tensor per LM step)
refine_bundle.host_reads = 0
