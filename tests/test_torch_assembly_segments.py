"""The dense assembly's segment sums: ``xmtpu_torch`` against ``xmtpu``.

The port sums ``q2``, ``Q1`` and ``V1`` by frame and ``q3`` by landmark
through ``segsum.sorted_segment_sum`` (``Segments``: one stable sort of the
ids, each segment's rows in edge order), and puts ``V3`` / ``V2`` without
accumulation, summing a repeated (frame, landmark) pair's rows by pair
first.  On the host the sums are those of ``index_add_`` in edge order, so
``create_matrix_arrays`` agrees with the JAX package's at the tolerances of
``tests/test_torch_assembly.py``: 1e-10 of the largest entry in f64, 1e-4
in ``"mixed"`` (the f32 middle's own error is ~1e-6 relative).
"""

import numpy as np
import pytest
import torch

from xmtpu.assembly import creatematrix as jcm
from xmtpu_torch.assembly import creatematrix as tcm
from xmtpu_torch.ops import segsum as ss
from xmtpu_torch.pipeline import synthetic as tsyn

# scene A of chip_smoke.py (the saddle-escape anchor, n=120)
SCENE_A = dict(n_cameras=120, n_points=400, obs_per_camera=10, noise=0.35,
               seed=1)
# every camera sees ~200 landmarks: its frame sum is a long segment
# (more than ss.CSR_LONG rows)
SCENE_LONG = dict(n_cameras=6, n_points=300, obs_per_camera=200, noise=0.1,
                  seed=2)
TOL = {"f64": 1e-10, "mixed": 1e-4}


def _close_rel(got, want, rel):
    want = np.asarray(want)
    got = got.cpu().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=rel * float(np.abs(want).max()))


def _parity(weights, edges, landmarks, precision):
    Cj, Aj = jcm.create_matrix_arrays(weights, edges, landmarks,
                                      precision=precision)
    Ct, At = tcm.create_matrix_arrays(weights, edges, landmarks,
                                      precision=precision, device="cpu")
    _close_rel(Ct, Cj, TOL[precision])
    _close_rel(At, Aj, TOL[precision])
    assert torch.equal(Ct, Ct.T)


def _repeated(seed=4):
    """A scene whose edges come in shuffled order, a third of them twice
    (the repeat with half the weight and a moved landmark)."""
    sc = tsyn.make_scene(n_cameras=30, n_points=120, obs_per_camera=8,
                         noise=0.1, seed=3)
    rng = np.random.default_rng(seed)
    k = rng.choice(len(sc.edges), size=len(sc.edges) // 3, replace=False)
    edges = np.concatenate([sc.edges, sc.edges[k]])
    weights = np.concatenate([sc.weights, 0.5 * sc.weights[k]])
    landmarks = np.concatenate([sc.landmarks, sc.landmarks[k] + 0.01])
    perm = rng.permutation(len(edges))
    return weights[perm], edges[perm], landmarks[perm]


def _sums(edges):
    N, M = int(edges[:, 0].max()), int(edges[:, 1].max())
    return tcm._edge_sums(edges[:, 0] - 1, edges[:, 1] - 1, N, M, "cpu")


@pytest.mark.parametrize("precision", ["f64", "mixed"])
def test_scene_a_parity(precision):
    sc = tsyn.make_scene(**SCENE_A)
    sums = _sums(sc.edges)
    assert sums.pair is None
    assert sums.frame.offsets.csr_plan.n_long == 0
    _parity(sc.weights, sc.edges, sc.landmarks, precision)


@pytest.mark.parametrize("precision", ["f64", "mixed"])
def test_repeated_pairs_parity(precision):
    weights, edges, landmarks = _repeated()
    sums = _sums(edges)
    n_pairs = len(np.unique(edges, axis=0))
    assert sums.pair is not None and sums.pair.num_segments == n_pairs
    assert sums.pair.offsets.csr_plan.layout == "assembly pair"
    assert len(sums.at[0]) == n_pairs < len(edges)
    _parity(weights, edges, landmarks, precision)


@pytest.mark.parametrize("precision", ["f64", "mixed"])
def test_long_frame_segments_parity(precision):
    sc = tsyn.make_scene(**SCENE_LONG)
    plan = _sums(sc.edges).frame.offsets.csr_plan
    assert plan.layout == "assembly frame"
    assert plan.n_long >= 1 and plan.longest > ss.CSR_LONG
    _parity(sc.weights, sc.edges, sc.landmarks, precision)


@pytest.mark.parametrize("case", ["scene A", "repeated pairs"])
def test_every_sum_goes_through_sorted_segment_sum(case, monkeypatch):
    """``q2``, ``Q1``, ``V1`` (one launch by frame, D = 13) and ``q3`` (by
    landmark, D = 1) are ``sorted_segment_sum``'s results; no
    ``index_add_`` runs outside it, and the only accumulating
    ``index_put_`` is Q1's into C's distinct diagonal-block entries."""
    if case == "scene A":
        sc = tsyn.make_scene(**SCENE_A)
        weights, edges, landmarks = sc.weights, sc.edges, sc.landmarks
    else:
        weights, edges, landmarks = _repeated()
    N, M = int(edges[:, 0].max()), int(edges[:, 1].max())
    calls, inside, loose, puts = [], [0], [], []
    kernel, index_add, index_put = (ss.sorted_segment_sum,
                                    torch.Tensor.index_add_,
                                    torch.Tensor.index_put_)

    def spy(vals, seg_ids, num_segments, *a, **k):
        inside[0] += 1
        try:
            out = kernel(vals, seg_ids, num_segments, *a, **k)
        finally:
            inside[0] -= 1
        calls.append((k["offsets"].csr_plan.layout, num_segments,
                      vals.shape[1], out))
        return out

    def watched_add(self, *a, **k):
        if not inside[0]:
            loose.append(a)
        return index_add(self, *a, **k)

    def watched_put(self, indices, values, accumulate=False):
        if accumulate:
            at = torch.broadcast_tensors(*indices)
            puts.append([tuple(ij) for ij in torch.stack(
                [i.reshape(-1) for i in at]).T.tolist()])
        return index_put(self, indices, values, accumulate)

    monkeypatch.setattr(ss, "sorted_segment_sum", spy)
    monkeypatch.setattr(torch.Tensor, "index_add_", watched_add)
    monkeypatch.setattr(torch.Tensor, "index_put_", watched_put)
    C, _ = tcm.create_matrix_arrays(weights, edges, landmarks, device="cpu")
    monkeypatch.undo()

    assert not loose
    assert len(puts) == 1 and len(set(puts[0])) == len(puts[0]) == 9 * N
    by = {layout: (S, D, out) for layout, S, D, out in calls}
    assert len(by) == len(calls)
    assert set(by) == ({"assembly frame", "assembly landmark"}
                       | ({"assembly pair"} if case != "scene A" else set()))
    assert by["assembly frame"][:2] == (N, 13)
    assert by["assembly landmark"][:2] == (M, 1)
    # the sums themselves, against numpy's in edge order
    f, l = edges[:, 0] - 1, edges[:, 1] - 1
    wx = weights[:, None] * landmarks
    frame = np.zeros((N, 13))
    np.add.at(frame, f, np.concatenate(
        [weights[:, None], wx,
         (wx[:, :, None] * landmarks[:, None, :]).reshape(-1, 9)], axis=1))
    q3 = np.zeros((M, 1))
    np.add.at(q3, l, weights[:, None])
    np.testing.assert_allclose(by["assembly frame"][2].numpy(), frame,
                               rtol=1e-13, atol=0.0)
    np.testing.assert_allclose(by["assembly landmark"][2].numpy(), q3,
                               rtol=1e-13, atol=0.0)
    Cj, _ = jcm.create_matrix_arrays(weights, edges, landmarks)
    _close_rel(C, Cj, TOL["f64"])
