"""View-graph cleanup: frame/landmark filtering, anchoring, largest component.

A copy of ``xmtpu/pipeline/graph.py`` (pure numpy) on the port's own native
union-find (``xmtpu_torch/runtime``), so the port never imports the JAX
package.  Same outputs, array for array.

Semantics (the reference's ``checkconnection.py``):
* drop frames with <= 10 observations and landmarks seen in <= 1 frame —
  thresholds are parameters here;
* swap the densest frame to index 0, which becomes the anchor;
* keep the largest connected component of the bipartite frame-landmark
  graph;
* maintain ``indices_all``, the original-frame-index -> new-index map.

Edges are 1-based ``[frame, landmark]`` throughout, matching the reference.
"""

from __future__ import annotations

import numpy as np

from xmtpu_torch.runtime import connected_component_labels


def delete_threshold(min_threshold: int, M: int, data: np.ndarray):
    """Reindex ids with fewer than ``min_threshold`` occurrences to -1.

    ``data`` holds 0-based ids; returns ``(argmax_id, num_valid, index_map)``
    (the reference's ``delete_thereshold``).
    """
    counts = np.bincount(data, minlength=M)
    valid = counts > min_threshold
    num_valid = int(np.sum(valid))
    index_map = np.full(M, -1, dtype=int)
    index_map[valid] = np.arange(num_valid)
    return int(np.argmax(counts)), num_valid, index_map


# keep the reference's (misspelled) name importable for drop-in use
delete_thereshold = delete_threshold


def _compose(indices_all: np.ndarray, indices_frame: np.ndarray) -> np.ndarray:
    """indices_all[j] -> indices_frame[indices_all[j]] (keeping -1)."""
    out = indices_all.copy()
    live = indices_all > -1
    out[live] = indices_frame[indices_all[live]]
    return out


def _apply_frame_map(edges, arrays, index_map):
    """Remap edges[:,0] through index_map (1-based) and drop -1 rows."""
    edges = edges.copy()
    edges[:, 0] = index_map[edges[:, 0] - 1] + 1
    keep = ~np.any(edges == 0, axis=1)
    return edges[keep], [a[keep] for a in arrays]


def _apply_landmark_map(edges, arrays, index_map):
    edges = edges.copy()
    edges[:, 1] = index_map[edges[:, 1] - 1] + 1
    keep = ~np.any(edges == 0, axis=1)
    return edges[keep], [a[keep] for a in arrays]


def checklandmarks(edges, landmarks, weights, rgbs, N, M,
                   frame_min_obs: int = 10, landmark_min_frames: int = 1):
    """Clean the view graph; returns ``(edges, landmarks, weights, rgbs,
    indices_all)`` with the same meaning as the reference."""
    edges = np.asarray(edges).copy()
    landmarks = np.asarray(landmarks)
    weights = np.asarray(weights)
    rgbs = np.asarray(rgbs)

    # drop sparse frames, anchor the densest one at index 0
    max_frame, N, indices_frame = delete_threshold(frame_min_obs, N, edges[:, 0] - 1)
    if indices_frame[max_frame] != 0:
        indices_frame[indices_frame == 0] = indices_frame[max_frame]
        indices_frame[max_frame] = 0
    indices_all = indices_frame.copy()
    edges, (weights, landmarks, rgbs) = _apply_frame_map(
        edges, [weights, landmarks, rgbs], indices_frame)

    # drop landmarks seen in too few frames
    _, M, indices_landmarks = delete_threshold(landmark_min_frames, M, edges[:, 1] - 1)
    edges, (weights, rgbs, landmarks) = _apply_landmark_map(
        edges, [weights, rgbs, landmarks], indices_landmarks)

    # re-compact frames after the landmark drop
    _, N, indices_frame = delete_threshold(0, N, edges[:, 0] - 1)
    indices_all = _compose(indices_all, indices_frame)
    edges, (weights, landmarks, rgbs) = _apply_frame_map(
        edges, [weights, landmarks, rgbs], indices_frame)

    # largest connected component of the bipartite frame-landmark graph
    # (native union-find when built; see xmtpu_torch/runtime)
    f = edges[:, 0] - 1
    l = edges[:, 1] - 1
    n_comp, labels = connected_component_labels(f, l + N, N + M)
    print("Number of connected components: ", n_comp)
    if n_comp > 1:
        sizes = np.bincount(labels[np.unique(np.concatenate([f, l + N]))],
                            minlength=n_comp)
        largest = int(np.argmax(sizes))
        keep = (labels[f] == largest) & (labels[l + N] == largest)
        if int(keep.sum()) < len(edges):
            print("Not connected, Choose Largest Component")
            edges = edges[keep]
            weights = weights[keep]
            rgbs = rgbs[keep]
            landmarks = landmarks[keep]
            _, N, indices_frame = delete_threshold(0, N, edges[:, 0] - 1)
            indices_all = _compose(indices_all, indices_frame)
            edges, (weights, landmarks, rgbs) = _apply_frame_map(
                edges, [weights, landmarks, rgbs], indices_frame)
            _, M, indices_landmarks = delete_threshold(0, M, edges[:, 1] - 1)
            edges = edges.copy()
            edges[:, 1] = indices_landmarks[edges[:, 1] - 1] + 1

    return edges, landmarks, weights, rgbs, indices_all
