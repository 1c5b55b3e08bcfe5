"""View-graph manipulation: sparsification, strong clustering, pose decomposition.

Vectorized re-designs of the remaining GLOMAP graph processors
(deps/glomap/glomap/processors/view_graph_manipulation.cc,
processors/reconstruction_pruning.cc, math/tree.cc). The reference walks
hash maps of ``ImagePair`` structs; here a view graph is plain arrays —
``pairs`` is (P, 2) int image indices with a parallel ``valid`` mask — so
every pass is a few numpy ops and the connected-component work reuses the
native union-find (:mod:`xmtpu_torch.runtime`).

Two-view configuration codes follow colmap::TwoViewGeometry:
UNDEFINED=0, DEGENERATE=1, CALIBRATED=2, UNCALIBRATED=3, PLANAR=4,
PANORAMIC=5, PLANAR_OR_PANORAMIC=6, WATERMARK=7, MULTIPLE=8.

The port's copy of ``xmtpu/pipeline/manipulation.py`` (numpy; the port never
imports the JAX package, not even its numpy-only modules).
"""

from __future__ import annotations

import numpy as np

from .. import runtime

UNDEFINED, DEGENERATE, CALIBRATED, UNCALIBRATED = 0, 1, 2, 3
PLANAR, PANORAMIC, PLANAR_OR_PANORAMIC, WATERMARK, MULTIPLE = 4, 5, 6, 7, 8

# Strong-cluster criteria (view_graph_manipulation.h enum)
INLIER_NUM, WEIGHT, INLIER_RATIO = 0, 1, 2


def _component_labels(pairs, valid, n_images):
    """Connected-component label per image over the valid edges; images with
    no valid edge get label -1 (they are absent from the reference's
    adjacency list, view_graph.cc:110-118)."""
    pairs = np.asarray(pairs)
    v = np.asarray(valid, dtype=bool)
    u1, u2 = pairs[v, 0], pairs[v, 1]
    _, labels = runtime.connected_component_labels(u1, u2, n_images)
    labels = np.asarray(labels)
    touched = np.zeros(n_images, dtype=bool)
    touched[u1] = True
    touched[u2] = True
    return np.where(touched, labels, -1)


def keep_largest_connected_component(pairs, valid, n_images):
    """``ViewGraph::KeepLargestConnectedComponents`` (view_graph.cc:9-45).

    Returns ``(registered, valid_new, num_images)`` — the is_registered mask,
    the pair validity with cross-component pairs invalidated, and the size of
    the largest component.
    """
    labels = _component_labels(pairs, valid, n_images)
    have = labels >= 0
    if not have.any():
        return np.zeros(n_images, dtype=bool), np.zeros(len(pairs),
                                                        dtype=bool), 0
    counts = np.bincount(labels[have])
    best = int(np.argmax(counts))
    registered = labels == best
    pairs = np.asarray(pairs)
    valid_new = (np.asarray(valid, dtype=bool) & registered[pairs[:, 0]]
                 & registered[pairs[:, 1]])
    return registered, valid_new, int(counts[best])


def mark_connected_components(pairs, valid, n_images, min_num_img: int = 1):
    """``ViewGraph::MarkConnectedComponents`` (view_graph.cc:65-90): cluster
    ids ordered by component size (0 = largest); components smaller than
    ``min_num_img`` — and isolated images — get -1.

    Returns ``(cluster_ids, num_clusters)``.
    """
    labels = _component_labels(pairs, valid, n_images)
    have = labels >= 0
    cluster = np.full(n_images, -1, dtype=np.int64)
    if not have.any():
        return cluster, 0
    counts = np.bincount(labels[have])
    order = np.argsort(-counts, kind="stable")
    kept = order[counts[order] >= min_num_img]
    remap = np.full(len(counts), -1, dtype=np.int64)
    remap[kept] = np.arange(len(kept))
    cluster[have] = remap[labels[have]]
    return cluster, int(len(kept))


def sparsify_graph(pairs, valid, n_images, expected_degree: int = 48,
                   rng=None):
    """``ViewGraphManipulater::SparsifyGraph``
    (view_graph_manipulation.cc:10-66): random edge subsampling that keeps
    each edge with probability ``expected_degree * avg_degree /
    (deg1 * deg2)`` while always keeping edges at low-degree vertices, then
    re-keeps the largest component.

    Returns ``(registered, valid_new, n_chosen)``.
    """
    rng = np.random.default_rng(0) if rng is None else rng
    registered, valid, num_img = keep_largest_connected_component(
        pairs, valid, n_images)
    pairs = np.asarray(pairs)
    v = np.asarray(valid, dtype=bool)

    # degree over the unique undirected adjacency of valid pairs (cc:18-27)
    deg = np.zeros(n_images, dtype=np.int64)
    if v.any():
        uniq = np.unique(np.sort(pairs[v], axis=1), axis=0)
        deg += np.bincount(uniq[:, 0], minlength=n_images)
        deg += np.bincount(uniq[:, 1], minlength=n_images)
    avg_degree = deg[registered].sum() / max(num_img, 1)

    d1 = deg[pairs[:, 0]]
    d2 = deg[pairs[:, 1]]
    keep_low = (d1 <= expected_degree) | (d2 <= expected_degree)
    prob = (expected_degree * avg_degree) / np.maximum(d1 * d2, 1)
    chosen = v & (keep_low | (rng.random(len(pairs)) < prob))

    registered, valid_new, _ = keep_largest_connected_component(
        pairs, chosen, n_images)
    return registered, valid_new, int(chosen.sum())


def establish_strong_clusters(pairs, valid, weights, n_images,
                              min_thres: float, min_num_images: int = 2,
                              max_iterations: int = 10):
    """``ViewGraphManipulater::EstablishStrongClusters``
    (view_graph_manipulation.cc:68-168).

    Seeds clusters from edges with ``weight > min_thres``, then repeatedly
    merges clusters joined by >= 2 moderately strong edges
    (``weight >= 0.75 * min_thres``, cc:92-148), invalidates cross-cluster
    pairs, and marks components.

    Returns ``(cluster_ids, valid_new, num_clusters)``.
    """
    pairs = np.asarray(pairs)
    valid = np.asarray(valid, dtype=bool)
    w = np.asarray(weights, dtype=np.float64)

    strong = valid & (w > min_thres)
    _, root = runtime.connected_component_labels(
        pairs[strong, 0], pairs[strong, 1], n_images)
    root = np.asarray(root)

    moderate = valid & (w >= 0.75 * min_thres)
    for _ in range(max_iterations):
        r1 = root[pairs[moderate, 0]]
        r2 = root[pairs[moderate, 1]]
        cross = r1 != r2
        if not cross.any():
            break
        # count moderate edges between each unordered root pair (cc:105-136)
        a = np.minimum(r1[cross], r2[cross])
        b = np.maximum(r1[cross], r2[cross])
        key = a * n_images + b
        uk, counts = np.unique(key, return_counts=True)
        merge = uk[counts >= 2]
        if merge.size == 0:
            break
        ma, mb = merge // n_images, merge % n_images
        _, root2 = runtime.connected_component_labels(ma, mb, n_images)
        root = np.asarray(root2)[root]

    valid_new = valid & (root[pairs[:, 0]] == root[pairs[:, 1]])
    cluster, num = mark_connected_components(pairs, valid_new, n_images,
                                             min_num_images)
    return cluster, valid_new, num


def update_image_pairs_config(pairs, valid, config, camera_of_image,
                              has_prior_focal):
    """``ViewGraphManipulater::UpdateImagePairsConfig``
    (view_graph_manipulation.cc:170-231): promote UNCALIBRATED pairs to
    CALIBRATED when both cameras have prior focals and are "valid" — i.e.
    > 50% of their prior-focal pairs are already CALIBRATED.

    Returns the new config array; callers refresh F via
    :func:`xmtpu_torch.pipeline.calibration.fundamental_from_pose` for the
    promoted pairs (cc:227-229).
    """
    pairs = np.asarray(pairs)
    config = np.asarray(config).copy()
    valid = np.asarray(valid, dtype=bool)
    cam = np.asarray(camera_of_image)
    hp = np.asarray(has_prior_focal, dtype=bool)

    c1 = cam[pairs[:, 0]]
    c2 = cam[pairs[:, 1]]
    both_prior = valid & hp[c1] & hp[c2]
    n_cams = int(cam.max()) + 1 if cam.size else 0

    def _count(mask):
        return (np.bincount(c1[mask], minlength=n_cams)
                + np.bincount(c2[mask], minlength=n_cams))

    total = _count(both_prior & ((config == CALIBRATED)
                                 | (config == UNCALIBRATED)))
    calib = _count(both_prior & (config == CALIBRATED))
    cam_ok = np.zeros(n_cams, dtype=bool)
    nz = total > 0
    cam_ok[nz] = calib[nz] / total[nz] > 0.5

    promote = valid & (config == UNCALIBRATED) & cam_ok[c1] & cam_ok[c2]
    config[promote] = CALIBRATED
    return config, promote


def pose_from_essential(E, b1, b2):
    """Recover (R, t) cam2_from_cam1 from an essential matrix by cheirality
    voting over the four decompositions (the role colmap's
    ``EstimateTwoViewGeometryPose`` plays in
    view_graph_manipulation.cc:262-291).

    Args:
      E: (3,3); b1, b2: (K,3) unit bearings of inlier correspondences.

    Returns ``(R, t_unit, n_votes)``.
    """
    from .viewgraph import check_cheirality

    U, _, Vt = np.linalg.svd(np.asarray(E, dtype=np.float64))
    if np.linalg.det(U) < 0:
        U = -U
    if np.linalg.det(Vt) < 0:
        Vt = -Vt
    W = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    Ra = U @ W @ Vt
    Rb = U @ W.T @ Vt
    tu = U[:, 2]

    best = (np.eye(3), np.array([0.0, 0.0, 1.0]), -1)
    for R in (Ra, Rb):
        for t in (tu, -tu):
            votes = int(check_cheirality(R, t, b1, b2).sum())
            if votes > best[2]:
                best = (R, t, votes)
    R, t, votes = best
    nt = np.linalg.norm(t)
    if nt > 1e-12:
        t = t / nt
    return R, t, votes


def decompose_relpose(pairs, valid, config, E, bearings1, bearings2,
                      camera_of_image, has_prior_focal):
    """``ViewGraphManipulater::DecomposeRelPose``
    (view_graph_manipulation.cc:234-305): for valid pairs whose cameras both
    carry prior focals, re-estimate (R, t) from the stored essential matrix
    with cheirality voting; PLANAR pairs with prior focals are promoted to
    CALIBRATED keeping their stored pose (cc:275-279); translations are
    normalized (cc:287-290).

    Args:
      E: (P,3,3) essential matrices; bearings1/2: length-P lists of (K_p,3)
        inlier bearing arrays (ragged — pair inlier sets differ in size).

    Returns ``(R, t, config_new)`` with (P,3,3)/(P,3) pose arrays (identity /
    +z for untouched pairs).
    """
    pairs = np.asarray(pairs)
    P = len(pairs)
    config = np.asarray(config).copy()
    cam = np.asarray(camera_of_image)
    hp = np.asarray(has_prior_focal, dtype=bool)
    eligible = (np.asarray(valid, dtype=bool)
                & hp[cam[pairs[:, 0]]] & hp[cam[pairs[:, 1]]])

    R_out = np.tile(np.eye(3), (P, 1, 1))
    t_out = np.tile(np.array([0.0, 0.0, 1.0]), (P, 1))
    for p in np.flatnonzero(eligible):
        if config[p] == PLANAR:
            config[p] = CALIBRATED
            continue
        R, t, votes = pose_from_essential(E[p], bearings1[p], bearings2[p])
        R_out[p] = R
        t_out[p] = t
        if votes > 0:
            config[p] = CALIBRATED
    return R_out, t_out, config


def maximum_spanning_tree(pairs, valid, weights, n_images, root: int = 0):
    """``MaximumSpanningTree`` + ``BFS`` (math/tree.cc:26-153): Kruskal MST
    on ``max_weight - weight`` edges, then BFS parent assignment from
    ``root``. Returns ``parents`` (N,) with ``parents[root] == root`` and -1
    for unreachable images.
    """
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import breadth_first_order, minimum_spanning_tree

    pairs = np.asarray(pairs)
    v = np.asarray(valid, dtype=bool)
    w = np.asarray(weights, dtype=np.float64)[v]
    i, j = pairs[v, 0], pairs[v, 1]
    max_w = w.max() if w.size else 0.0
    # shift so all weights are positive; scipy's MST treats 0 as "no edge"
    g = coo_matrix((max_w - w + 1.0, (i, j)), shape=(n_images, n_images))
    mst = minimum_spanning_tree(g)
    mst = mst + mst.T
    order, pred = breadth_first_order(mst, root, directed=False,
                                      return_predecessors=True)
    parents = np.where(pred >= 0, pred, -1).astype(np.int64)
    parents[root] = root
    return parents


def covisibility_pairs(edges, n_images, min_track_size: int = 3):
    """Per-image-pair covisibility counts from the observation arrays.

    The pair-accumulation loop of ``PruneWeaklyConnectedImages``
    (reconstruction_pruning.cc:11-32): tracks with <= 2 observations are
    skipped; every intra-track image pair contributes one count. Done as
    padded same-size batches + one ``np.unique`` instead of nested loops.

    Returns ``(pairs (P,2), counts (P,), image_obs_count (N,))``.
    """
    edges = np.asarray(edges)
    tsize = np.bincount(edges[:, 1])
    keep = tsize[edges[:, 1]] >= min_track_size
    e = edges[keep]
    image_obs_count = np.bincount(e[:, 0], minlength=n_images)

    order = np.argsort(e[:, 1], kind="stable")
    tj = e[order, 1]
    frames = e[order, 0]
    _, starts, counts = np.unique(tj, return_index=True, return_counts=True)

    keys = []
    for k in np.unique(counts):
        if k < 2:
            continue
        sel = np.flatnonzero(counts == k)
        idx = starts[sel][:, None] + np.arange(k)[None, :]
        F = frames[idx]                                   # (B, k)
        iu, ju = np.triu_indices(k, 1)
        a = F[:, iu].ravel()
        b = F[:, ju].ravel()
        ok = a != b                                       # cc:21
        lo = np.minimum(a[ok], b[ok])
        hi = np.maximum(a[ok], b[ok])
        keys.append(lo.astype(np.int64) * n_images + hi)
    if not keys:
        return (np.zeros((0, 2), dtype=np.int64), np.zeros(0, dtype=np.int64),
                image_obs_count)
    uk, cnt = np.unique(np.concatenate(keys), return_counts=True)
    pairs = np.stack([uk // n_images, uk % n_images], axis=1)
    return pairs, cnt, image_obs_count


def prune_weakly_connected_images(edges, n_images, min_num_images: int = 2,
                                  min_num_observations: int = 0):
    """``PruneWeaklyConnectedImages`` (reconstruction_pruning.cc:6-84):
    build the covisibility graph (pairs with >= 5 shared tracks, cc:38-57),
    threshold at ``max(median - MAD, 20)`` of the pair counts (cc:60-80),
    and strong-cluster it.

    Returns ``(cluster_ids, num_clusters)`` — cluster 0 is the strongest
    component; weakly connected images get -1.
    """
    pairs, cnt, image_obs_count = covisibility_pairs(edges, n_images)
    strong_enough = cnt >= 5
    ok_obs = ((image_obs_count[pairs[:, 0]] >= min_num_observations)
              & (image_obs_count[pairs[:, 1]] >= min_num_observations))
    valid = strong_enough & ok_obs
    if not valid.any():
        return np.full(n_images, -1, dtype=np.int64), 0

    counts_kept = np.sort(cnt[strong_enough])
    median = counts_kept[len(counts_kept) // 2]
    mad = np.sort(np.abs(counts_kept - median))[len(counts_kept) // 2]
    thres = max(float(median - mad), 20.0)

    cluster, _, num = establish_strong_clusters(
        pairs, valid, cnt.astype(np.float64), n_images, thres,
        min_num_images)
    return cluster, num
