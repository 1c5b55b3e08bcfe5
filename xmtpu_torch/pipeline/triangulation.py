"""Track (re)triangulation: batched multi-view DLT + points-only refinement.

PyTorch counterpart of ``xmtpu/pipeline/triangulation.py``, a re-design of
GLOMAP's stage-7 ``RetriangulateTracks``
(deps/glomap/glomap/controllers/track_retriangulation.{h,cc}, present but
disabled in the XM fork, global_mapper.cc:324-378).  The reference
delegates to COLMAP's incremental triangulator: per-image triangulation,
``CompleteAndMergeTracks``, then up to ``ba_global_max_refinements = 5``
rounds of points-only global bundle adjustment
(track_retriangulation.cc:80-117) with reprojection filtering, stopping
when fewer than ``ba_global_max_refinement_change = 5e-4`` of the
observations change.

* **Triangulation** is one linear-algebra pass on ``device``: each
  observation contributes two DLT rows ``u * P_3 - P_1`` / ``v * P_3 -
  P_2``; the per-track 4x4 normal matrices ``A^T A`` (and the support
  counts) are summed by track through ``sorted_segment_sum`` over one
  stable permutation of the observations, and a batched ``eigh`` gives
  every homogeneous point at once (the smallest eigenvalue's eigenvector;
  ``h / h[3]`` removes its sign, so the points do not depend on the
  solver's choice of sign).
* **Completion** (colmap Triangulator::Complete semantics) re-admits any
  candidate observation whose reprojection error against the fresh point
  is below ``tri_complete_max_reproj_error`` — numpy gates on the host.
* **Refinement** runs the port's
  :func:`xmtpu_torch.pipeline.bundle_adjustment.bundle_adjustment` with
  everything but the points frozen.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from xmtpu_torch._device import resolve_device
from xmtpu_torch.ops.segsum import Segments


@dataclass
class TriangulatorOptions:
    """Mirrors glomap TriangulatorOptions (track_retriangulation.h:9-16) and
    the colmap refinement knobs the reference pins
    (track_retriangulation.cc:45-50, 80-117)."""

    tri_complete_max_reproj_error: float = 15.0   # pixels
    tri_merge_max_reproj_error: float = 15.0      # pixels
    tri_min_angle: float = 1.0                    # degrees
    min_num_matches: int = 15
    ba_global_max_refinements: int = 5            # colmap default
    ba_global_max_refinement_change: float = 5e-4


class TriangulationResult(NamedTuple):
    xyz: np.ndarray        # (M, 3) triangulated points
    valid: np.ndarray      # (M,) bool — enough support and finite solution
    keep_obs: np.ndarray   # (E,) bool — observation survives the gates


def triangulate_tracks(obs_image, obs_track, xy_norm, R, t, n_tracks,
                       weights=None, device=None):
    """Multi-view DLT of every track in one batched pass on ``device``
    (None = the CUDA card; raises without one unless ``"cpu"``).

    Args:
      obs_image: (E,) image index per observation.
      obs_track: (E,) track index per observation.
      xy_norm: (E, 2) undistorted *normalized* image coordinates.
      R, t: (N,3,3)/(N,3) cam_from_world poses.
      n_tracks: number of tracks M.
      weights: optional (E,) nonnegative per-observation weights (IRLS
        robustification); zero-weight observations do not count as support.

    Returns ``(xyz (M,3), valid (M,))``; tracks with fewer than two
    (positively weighted) observations are invalid (no parallax constraint
    exists).
    """
    dev = resolve_device(device)
    obs_track = np.asarray(obs_track, dtype=np.int64)
    if weights is None:
        weights = np.ones(len(obs_track), dtype=np.float64)

    def f64(a):
        return torch.as_tensor(np.array(a, dtype=np.float64), device=dev)

    i = torch.as_tensor(np.asarray(obs_image, dtype=np.int64), device=dev)
    xy, Rj, tj, w = f64(xy_norm), f64(R), f64(t), f64(weights)
    by_track = Segments(obs_track, n_tracks, dev, "tri track")

    P = torch.cat([Rj, tj[:, :, None]], dim=2)            # (N, 3, 4)
    Pe = P[i]                                             # (E, 3, 4)
    r1 = xy[:, 0:1] * Pe[:, 2] - Pe[:, 0]                 # (E, 4)
    r2 = xy[:, 1:2] * Pe[:, 2] - Pe[:, 1]
    AtA = w[:, None, None] * (torch.einsum("ea,eb->eab", r1, r1)
                              + torch.einsum("ea,eb->eab", r2, r2))
    G = by_track.sum(AtA)                                 # (M, 4, 4)
    counts = by_track.sum((w > 0).to(torch.float64)[:, None])[:, 0]
    # regularize empty blocks so eigh stays finite
    G = G + torch.eye(4, dtype=G.dtype, device=dev) * (counts < 2)[:, None,
                                                                   None]
    _, V = torch.linalg.eigh(G)
    h = V[:, :, 0]                                        # min eigvec
    hw = h[:, 3]
    scale = torch.where(torch.abs(hw) < 1e-12,
                        torch.sign(hw) * 1e-12 + (hw == 0) * 1e-12, hw)
    xyz = h[:, :3] / scale[:, None]
    finite = torch.all(torch.isfinite(xyz), dim=1) & (torch.abs(hw) > 1e-12)
    valid = finite & (counts >= 2)
    return xyz.cpu().numpy(), valid.cpu().numpy()


def retriangulate(obs_image, obs_xy, obs_track, R, t, cam_params,
                  camera_of_image, opts: TriangulatorOptions | None = None,
                  verbose: bool = False, device=None) -> TriangulationResult:
    """Stage-7 retriangulation (track_retriangulation.cc:13-133).

    ``obs_*`` are the full candidate observation arrays (all track members,
    including any dropped by earlier filters — the reference rebuilds from
    the database); poses stay fixed throughout, exactly like the reference's
    refinement configuration.  ``device``: where the triangulations and
    the BA rounds run (None = the CUDA card).
    """
    from .bundle_adjustment import (BundleAdjusterOptions, _undistorted_rays,
                                    bundle_adjustment)
    from .track_filter import filter_track_triangulation_angle

    device = resolve_device(device)
    opts = opts or TriangulatorOptions()
    obs_image = np.asarray(obs_image, dtype=np.int64)
    obs_track = np.asarray(obs_track, dtype=np.int64)
    obs_xy = np.asarray(obs_xy, dtype=np.float64)
    cam_params = np.asarray(cam_params, dtype=np.float64)
    cam_of = np.asarray(camera_of_image, dtype=np.int64)
    M = int(obs_track.max()) + 1 if len(obs_track) else 0
    E = len(obs_image)
    if E == 0:
        return TriangulationResult(np.zeros((0, 3)), np.zeros(0, bool),
                                   np.zeros(0, bool))

    rays = _undistorted_rays(obs_xy, cam_params, cam_of[obs_image])
    xy_norm = rays[:, :2] / rays[:, 2:3]

    focal = cam_params[cam_of[obs_image], :2].mean(axis=1)    # px/err scale

    def reproj_px(xyz_):
        x_cam = (np.einsum("eab,eb->ea", np.asarray(R)[obs_image],
                           xyz_[obs_track])
                 + np.asarray(t)[obs_image])
        z = x_cam[:, 2]
        good = z > 1e-12
        proj = x_cam[:, :2] / np.where(good, z, 1.0)[:, None]
        err = np.linalg.norm(proj - xy_norm, axis=1) * focal
        return np.where(good, err, np.inf)

    # fresh triangulation of every track from scratch, robustified: two
    # IRLS reweighting passes keep a gross outlier from poisoning its track
    # (in the incremental reference the outlier simply never joins)
    xyz, valid = triangulate_tracks(obs_image, obs_track, xy_norm, R, t, M,
                                    device=device)
    valid = np.array(valid)
    for _ in range(2):
        wts = np.minimum(1.0, opts.tri_complete_max_reproj_error
                         / np.maximum(reproj_px(xyz), 1e-12))
        xyz2, valid2 = triangulate_tracks(obs_image, obs_track, xy_norm,
                                          R, t, M, weights=wts,
                                          device=device)
        valid2 = np.array(valid2)
        xyz = np.where(valid2[:, None], xyz2, xyz)
        valid |= valid2

    # completion gate (colmap tri_complete_max_reproj_error, in pixels)
    keep = (reproj_px(xyz) < opts.tri_complete_max_reproj_error) \
        & valid[obs_track]

    # min triangulation angle over the kept support
    edges = np.stack([obs_image, obs_track], axis=1)
    _, keep_track = filter_track_triangulation_angle(
        edges[keep], R, t, xyz, opts.tri_min_angle)
    keep &= keep_track[obs_track]
    if verbose:
        print(f"[retriangulate] {int(valid.sum())}/{M} tracks, "
              f"{int(keep.sum())}/{E} observations after gates")

    # points-only global BA rounds (track_retriangulation.cc:94-117)
    ba_opts = BundleAdjusterOptions(optimize_rotations=False,
                                    optimize_translation=False,
                                    optimize_intrinsics=False,
                                    optimize_points=True,
                                    min_num_view_per_track=2,
                                    max_iterations=50)
    for ref_round in range(opts.ba_global_max_refinements):
        n_obs = int(keep.sum())
        if n_obs == 0:
            break
        res = bundle_adjustment(obs_image[keep], obs_xy[keep],
                                obs_track[keep], R, t, xyz, cam_params,
                                cam_of, ba_opts, device=device)
        xyz = res.xyz
        err = reproj_px(xyz)
        # completion semantics: observations re-enter when the refined point
        # explains them (colmap CompleteAndMergeTracks per refinement round)
        new_keep = ((err < opts.tri_complete_max_reproj_error)
                    & valid[obs_track] & keep_track[obs_track])
        changed = int((keep != new_keep).sum())
        keep = new_keep
        if verbose:
            print(f"[retriangulate] refinement {ref_round + 1}: cost "
                  f"{res.cost_initial:.3e} -> {res.cost_final:.3e}, "
                  f"{changed} observations changed")
        if changed < opts.ba_global_max_refinement_change * max(n_obs, 1):
            break

    support = np.bincount(obs_track[keep], minlength=M)
    valid &= support >= 2
    keep &= valid[obs_track]
    return TriangulationResult(np.asarray(xyz), valid, keep)
