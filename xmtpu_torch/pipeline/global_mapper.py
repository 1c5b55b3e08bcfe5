"""Global mapper: the GLOMAP stage-0..4 pipeline on a COLMAP database.

PyTorch counterpart of ``xmtpu/pipeline/global_mapper.py``, the native
equivalent of the reference's truncated ``GlobalMapper::Solve``
(deps/glomap/glomap/controllers/global_mapper.cc:17-186), which the XM
driver invokes as a subprocess and re-parses from text files
(`3_test_colmap_glomap.py:100-192`). The stages run in-process on the flat
arrays of :class:`xmtpu_torch.pipeline.colmap_db.ViewGraphData`:

  0. preprocessing — pair-config promotion + relative-pose decomposition
     (global_mapper.cc:23-35)
  1. view-graph calibration — Fetzer focal refinement
     (global_mapper.cc:38-46), on ``device``
  2. relative poses + inlier counting + FilterInlierNum/Ratio + largest CC
     (global_mapper.cc:49-75)
  3. rotation averaging twice, purely as a relpose filter
     (global_mapper.cc:77-111), on ``device``
  4. track establishment + selection (global_mapper.cc:114-132)

Stages 0, 2 and 4 are numpy on the host, as in the reference.  The result
carries the payload the reference exports to
``tempdata/{output,filename,relative_pose}.txt`` (global_mapper.cc:134-184).

Stages 5-8 — global positioning, bundle adjustment, retriangulation,
pruning — are commented out of the XM fork (global_mapper.cc:188-390) and
sit behind skip flags that default to that truncation.  They are not ported
yet: a flag set to False raises ``NotImplementedError``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np

from xmtpu_torch._device import resolve_device
from xmtpu_torch.utils.timer import PhaseTimer

from . import manipulation as vm
from .calibration import CalibrationOptions, calibrate_view_graph
from .colmap_db import ViewGraphData
from .frontend import tracks_from_feature_matches
from .rotation_averaging import filter_pairs
from .undistort import undistorted_bearings
from .viewgraph import InlierThresholds, filter_pairs_by_inliers, pair_inliers


@dataclass
class GlobalMapperOptions:
    """Mirrors glomap's GlobalMapperOptions skip flags + thresholds
    (the XM driver only overrides max_num_view_per_track,
    3_test_colmap_glomap.py:109)."""

    skip_preprocessing: bool = False
    skip_view_graph_calibration: bool = False
    skip_relative_pose_estimation: bool = False
    skip_rotation_averaging: bool = False
    skip_track_establishment: bool = False
    # XM truncation: stages 5-8 are disabled in the reference fork
    # (global_mapper.cc:188-390); not ported yet, so False raises
    skip_global_positioning: bool = True
    skip_bundle_adjustment: bool = True
    skip_retriangulation: bool = True
    skip_pruning: bool = True
    inlier_thresholds: InlierThresholds = field(
        default_factory=InlierThresholds)
    max_rotation_error_deg: float = 10.0     # InlierThresholdOptions
    min_num_view_per_track: int = 3          # track_establishment.h:17
    max_num_view_per_track: int = 1000000    # XM override
    # FindTracksForProblem caps (track_establishment.h:13-22): -1 means
    # unlimited — the reference's int(-1) compared against unsigned counters
    # never triggers, so the defaults select every view-bounded track
    min_num_tracks_per_view: int = -1
    max_num_tracks: int = 10000000
    calibration: CalibrationOptions | None = None


class MapperResult(NamedTuple):
    """The reference's tempdata export, in memory (global_mapper.cc:134-184)
    plus the refined state."""

    obs_image: np.ndarray     # (E,) image index per observation
    obs_xy: np.ndarray        # (E, 2) pixel keypoints
    obs_track: np.ndarray     # (E,) track index (contiguous, 0-based)
    image_names: list
    registered: np.ndarray    # (N,) bool
    pair_valid: np.ndarray    # (P,) bool
    R_rel: np.ndarray         # (P, 3, 3) cam2_from_cam1
    t_rel: np.ndarray         # (P, 3) unit translations
    focals: np.ndarray        # (C,) refined focal per camera
    n_tracks: int
    # stage 5-8 outputs (None: the XM truncation, the only one ported)
    R_global: np.ndarray | None = None   # (N, 3, 3) cam_from_world
    t_global: np.ndarray | None = None   # (N, 3) cam_from_world translations
    xyz: np.ndarray | None = None        # (n_tracks, 3); NaN = untriangulated
    cluster_ids: np.ndarray | None = None  # (N,) stage-8 clusters


def _with_focal(cam, f: float):
    """Return a copy of the camera with its focal entries replaced."""
    from .undistort import _FOCAL_LAYOUT, Camera

    fx, fy, _, _, _ = _FOCAL_LAYOUT[cam.model]
    params = np.asarray(cam.params, dtype=np.float64).copy()
    params[fx] = params[fy] = f
    return Camera(model=cam.model, params=params, width=cam.width,
                  height=cam.height,
                  has_prior_focal_length=cam.has_prior_focal_length)


def _pair_bearings(vg: ViewGraphData, cameras, p):
    i1, i2 = vg.pairs[p]
    m = vg.matches[p]
    b1 = undistorted_bearings(cameras[vg.camera_of_image[i1]],
                              vg.keypoints[i1][m[:, 0]])
    b2 = undistorted_bearings(cameras[vg.camera_of_image[i2]],
                              vg.keypoints[i2][m[:, 1]])
    return b1, b2


TAIL_STAGES_TODO = ("stages 5-8 of the global mapper (global positioning, "
                    "bundle adjustment, retriangulation, pruning) are not "
                    "ported to xmtpu_torch yet (ROADMAP.md, queue 1, item "
                    "13); keep skip_global_positioning, "
                    "skip_bundle_adjustment, skip_retriangulation and "
                    "skip_pruning True")


def global_mapper_solve(vg: ViewGraphData,
                        opts: GlobalMapperOptions | None = None,
                        verbose: bool = False,
                        device=None) -> MapperResult:
    """Stages 0-4 on ``vg``.  ``device``: where stages 1 and 3 run (None =
    the CUDA card; raises without one unless ``"cpu"``).  At ``verbose``
    each stage's log line, then their seconds."""
    opts = opts or GlobalMapperOptions()
    if not (opts.skip_global_positioning and opts.skip_bundle_adjustment
            and opts.skip_retriangulation and opts.skip_pruning):
        raise NotImplementedError(TAIL_STAGES_TODO)
    dev = resolve_device(device)
    timer = PhaseTimer()
    N = len(vg.image_ids)
    P = len(vg.pairs)
    valid = vg.valid.copy()
    config = vg.config.copy()
    cameras = list(vg.cameras)
    focals = np.array([c.focal for c in cameras], dtype=np.float64)

    R_rel = np.tile(np.eye(3), (P, 1, 1))
    t_rel = np.tile(np.array([0.0, 0.0, 1.0]), (P, 1))

    def log(msg):
        if verbose:
            print(f"[global_mapper] {msg}")

    # ---- 0. preprocessing (global_mapper.cc:23-35) ----
    with timer.phase("0_preprocessing"):
        if not opts.skip_preprocessing:
            config, promoted = vm.update_image_pairs_config(
                vg.pairs, valid, config, vg.camera_of_image,
                vg.has_prior_focal)
            bearings = {p: _pair_bearings(vg, cameras, p)
                        for p in np.flatnonzero(valid)}
            for p in np.flatnonzero(valid & (config == vm.CALIBRATED)):
                E = vg.E[p]
                if not np.any(E):
                    continue
                b1, b2 = bearings[p]
                if len(b1) < 5:
                    continue
                R, t, votes = vm.pose_from_essential(E, b1, b2)
                if votes > 0:
                    R_rel[p], t_rel[p] = R, t
            log(f"preprocessing: {int(promoted.sum())} pairs promoted")

    # ---- 1. view-graph calibration (global_mapper.cc:38-46) ----
    with timer.phase("1_calibration"):
        if not opts.skip_view_graph_calibration:
            pairs_with_F = np.flatnonzero(valid & np.any(
                vg.F.reshape(P, 9) != 0, axis=1))
            if pairs_with_F.size:
                pp = np.array([[c.K[0, 2], c.K[1, 2]] for c in cameras])
                out = calibrate_view_graph(
                    vg.F[pairs_with_F],
                    vg.camera_of_image[vg.pairs[pairs_with_F, 0]],
                    vg.camera_of_image[vg.pairs[pairs_with_F, 1]],
                    pp, focals, prior_mask=vg.has_prior_focal,
                    opts=opts.calibration, device=dev)
                focals = np.asarray(out["focals"], dtype=np.float64)
                valid[pairs_with_F] &= np.asarray(out["pair_valid"],
                                                  dtype=bool)
                cameras = [_with_focal(cam, focals[ci])
                           for ci, cam in enumerate(cameras)]
                log(f"calibration: focals {np.round(focals, 2)}")

    # ---- 2. relative pose + inlier filtering + largest CC (cc:49-75) ----
    with timer.phase("2_relative_pose"):
        if not opts.skip_relative_pose_estimation:
            thr = opts.inlier_thresholds
            inlier_counts = np.zeros(P)
            match_counts = np.maximum(
                np.array([len(m) for m in vg.matches]), 1)
            inlier_masks = [None] * P
            for p in np.flatnonzero(valid):
                b1, b2 = _pair_bearings(vg, cameras, p)
                if len(b1) < 5:
                    valid[p] = False
                    continue
                E = vg.E[p]
                if np.any(E):
                    R, t, votes = vm.pose_from_essential(E, b1, b2)
                    if votes > 0:
                        R_rel[p], t_rel[p] = R, t
                f1 = focals[vg.camera_of_image[vg.pairs[p, 0]]]
                f2 = focals[vg.camera_of_image[vg.pairs[p, 1]]]
                mask, _ = pair_inliers(R_rel[p], t_rel[p], b1, b2, f1, f2,
                                       thr)
                inlier_masks[p] = mask
                inlier_counts[p] = mask.sum()
            valid &= filter_pairs_by_inliers(inlier_counts, match_counts, thr)
            registered, valid, n_img = vm.keep_largest_connected_component(
                vg.pairs, valid, N)
            if n_img == 0:
                raise ValueError("no connected components are found")
            log(f"relpose: {int(valid.sum())}/{P} pairs, {n_img}/{N} images")
        else:
            inlier_masks = [np.ones(len(m), dtype=bool) for m in vg.matches]
            registered, valid, _ = vm.keep_largest_connected_component(
                vg.pairs, valid, N)

    # ---- 3. rotation averaging x2 as a filter (cc:77-111) ----
    with timer.phase("3_rotation_filter"):
        if not opts.skip_rotation_averaging:
            if opts.skip_relative_pose_estimation:
                inlier_counts = np.array([len(m) for m in vg.matches],
                                         dtype=np.float64)
            for it in range(2):
                sel = np.flatnonzero(valid)
                # MST init weighted by inlier counts
                # (InitializeFromMaximumSpanningTree, INLIER_NUM)
                keep, _ = filter_pairs(
                    vg.pairs[sel], R_rel[sel], N,
                    max_angle_deg=opts.max_rotation_error_deg,
                    weights=inlier_counts[sel], device=dev)
                valid[sel] &= keep
                registered, valid, n_img = \
                    vm.keep_largest_connected_component(vg.pairs, valid, N)
                if n_img == 0:
                    raise ValueError("no connected components are found")
            log(f"rotation filter: {int(valid.sum())} pairs, "
                f"{int(registered.sum())} images registered")

    # ---- 4. track establishment + selection (cc:114-132) ----
    with timer.phase("4_tracks"):
        obs_image = np.zeros(0, dtype=np.int64)
        obs_xy = np.zeros((0, 2))
        obs_track = np.zeros(0, dtype=np.int64)
        n_tracks = 0
        if not opts.skip_track_establishment:
            im1, f1, im2, f2 = [], [], [], []
            for p in np.flatnonzero(valid):
                m = vg.matches[p]
                mask = inlier_masks[p]
                if mask is not None and len(mask) == len(m):
                    m = m[mask]
                i1, i2 = vg.pairs[p]
                im1.extend([i1] * len(m))
                f1.extend(m[:, 0].tolist())
                im2.extend([i2] * len(m))
                f2.extend(m[:, 1].tolist())
            keys, tracks = tracks_from_feature_matches(im1, f1, im2, f2)
            images_idx = (keys >> 32).astype(np.int64)
            feats_idx = (keys & 0xFFFFFFFF).astype(np.int64)

            # FindTracksForProblem: keep tracks seen from enough *distinct*
            # images (track_establishment.cc:161-197)
            img_per_track = {}
            for ii, tr in zip(images_idx, tracks):
                img_per_track.setdefault(tr, set()).add(ii)
            sizes = np.array([len(img_per_track[t]) for t in tracks])
            keep = ((sizes >= opts.min_num_view_per_track)
                    & (sizes <= opts.max_num_view_per_track)
                    & registered[images_idx])
            images_idx, feats_idx, tracks = (
                images_idx[keep], feats_idx[keep], tracks[keep])
            uniq, tracks = np.unique(tracks, return_inverse=True)
            n_tracks = len(uniq)
            # FindTracksForProblem greedy coverage selection
            # (track_establishment.cc:152-226) — active only when the caps
            # bind
            if (opts.min_num_tracks_per_view >= 0
                    or n_tracks > opts.max_num_tracks):
                chosen = _select_tracks_greedy(
                    images_idx, tracks, n_tracks, N,
                    opts.min_num_tracks_per_view, opts.max_num_tracks)
                m = chosen[tracks]
                images_idx, feats_idx, tracks = (
                    images_idx[m], feats_idx[m], tracks[m])
                uniq, tracks = np.unique(tracks, return_inverse=True)
                n_tracks = len(uniq)
            obs_image = images_idx
            obs_xy = np.array([vg.keypoints[i][f]
                               for i, f in zip(images_idx, feats_idx)])
            obs_track = tracks
            log(f"tracks: {n_tracks} tracks, {len(obs_image)} observations")

    # ---- 5-8. full-GLOMAP stages: refused above (not ported yet) ----
    if verbose:
        print("[global_mapper phases]\n" + timer.report())
    return MapperResult(obs_image, obs_xy, obs_track, vg.image_names,
                        registered, valid, R_rel, t_rel, focals, n_tracks)


def prune_from_observations(edges, n_images):
    """Stage-8 wrapper (reconstruction_pruning.cc via manipulation)."""
    return vm.prune_weakly_connected_images(edges, n_images)


def _select_tracks_greedy(obs_img, obs_track, n_tracks, n_images,
                          min_per_view: int, max_tracks: int):
    """``FindTracksForProblem`` (track_establishment.cc:152-226): walk tracks
    longest-first, keep a track when it still serves some image whose
    per-view counter has not passed ``min_per_view``, stop once every image
    is covered or ``max_tracks`` is hit. Returns a (n_tracks,) keep mask."""
    lengths = np.bincount(obs_track, minlength=n_tracks)
    order = np.argsort(-lengths, kind="stable")
    sort_i = np.argsort(obs_track, kind="stable")
    starts = np.zeros(n_tracks + 1, dtype=np.int64)
    starts[1:] = np.cumsum(lengths)

    per_cam = np.zeros(n_images, dtype=np.int64)
    active = np.unique(obs_img)
    covered = 0
    selected = np.zeros(n_tracks, dtype=bool)
    n_selected = 0
    for t in order:
        if lengths[t] == 0:
            continue
        cams = obs_img[sort_i[starts[t]:starts[t + 1]]]
        addable = per_cam[cams] <= min_per_view      # cc:206 gate
        if not addable.any():
            continue
        np.add.at(per_cam, cams[addable], 1)
        covered = int((per_cam[active] > min_per_view).sum())
        selected[t] = True
        n_selected += 1
        if covered >= len(active):                   # cameras_left == 0
            break
        if n_selected > max_tracks:                  # cc:224
            break
    return selected


def export_tempdata(res: MapperResult, vg: ViewGraphData,
                    tempdata_dir: str) -> None:
    """Write the XM-GLOMAP export files (global_mapper.cc:134-184):
    ``output.txt`` (image_id u v track, 1-based track ids), ``filename.txt``
    (image_id name) and ``relative_pose.txt`` (id1 id2 qw qx qy qz tx ty tz)
    — readable by ``parse_glomap_tempdata`` of either package and by the
    reference driver (3_test_colmap_glomap.py:134-192)."""
    import os

    from .colmap_io import rot2quat

    os.makedirs(tempdata_dir, exist_ok=True)
    ids = np.asarray(vg.image_ids)
    with open(os.path.join(tempdata_dir, "output.txt"), "w") as f:
        for k in range(len(res.obs_image)):
            f.write(f"{ids[res.obs_image[k]]} "
                    f"{float(res.obs_xy[k, 0])!r} "
                    f"{float(res.obs_xy[k, 1])!r} {res.obs_track[k] + 1}\n")
    with open(os.path.join(tempdata_dir, "filename.txt"), "w") as f:
        for i, name in enumerate(res.image_names):
            f.write(f"{ids[i]} {name}\n")
    with open(os.path.join(tempdata_dir, "relative_pose.txt"), "w") as f:
        for p in np.flatnonzero(res.pair_valid):
            q = rot2quat(res.R_rel[p])
            t = res.t_rel[p]
            vals = " ".join(repr(float(v))
                             for v in (q[0], q[1], q[2], q[3],
                                       t[0], t[1], t[2]))
            f.write(f"{ids[vg.pairs[p, 0]]} {ids[vg.pairs[p, 1]]} "
                    f"{vals}\n")
