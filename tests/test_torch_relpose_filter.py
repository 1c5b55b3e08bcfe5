"""The relative-pose outlier filter of the port against the JAX package's:
the same seeded scenes, the same rows kept, exactly."""

import numpy as np
import pytest

from xmtpu.pipeline.relpose_filter import relpose_filter as jax_filter
from xmtpu.pipeline.synthetic import make_scene
from xmtpu_torch.pipeline.relpose_filter import relpose_filter


def _example_05(drop_pairs=()):
    """``examples/05_refine.py``'s scene: a thirtieth of the rows moved by
    N(0, 1) * 5, a relative pose for every pair but ``drop_pairs``; the
    rows are tagged through ``rgbs``."""
    scene = make_scene(n_cameras=10, n_points=60, obs_per_camera=40,
                       noise=2e-3, seed=1)
    rng = np.random.default_rng(1)
    bad = rng.choice(len(scene.edges), size=len(scene.edges) // 30,
                     replace=False)
    landmarks = scene.landmarks.copy()
    landmarks[bad] += rng.normal(size=(len(bad), 3)) * 5.0
    relposes = {}
    for i in range(scene.N):
        for j in range(i + 1, scene.N):
            if (i + 1, j + 1) not in drop_pairs:
                relposes[(i + 1, j + 1)] = (scene.R_gt[j].T @ scene.R_gt[i],
                                            np.zeros(3))
    rgbs = np.zeros((len(scene.edges), 3))
    rgbs[:, 0] = np.arange(len(scene.edges))
    return scene.edges, scene.weights, landmarks, rgbs, relposes, bad


@pytest.mark.parametrize("drop_pairs", [(), ((1, 2), (3, 7), (4, 5))],
                         ids=["every pair", "pairs without a relpose"])
def test_kept_rows_match(drop_pairs):
    edges, weights, landmarks, rgbs, relposes, bad = _example_05(drop_pairs)
    want = jax_filter(edges, weights, landmarks, rgbs, relposes,
                      verbose=False)
    got = relpose_filter(edges, weights, landmarks, rgbs, relposes,
                         verbose=False)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))
    kept = got[3][:, 0].astype(int)
    assert 0 < len(kept) < len(edges)
    # the planted rows are the ones it is meant to find
    assert np.isin(bad, kept).mean() < 0.5


def test_min_shared_and_verbose(capsys):
    edges, weights, landmarks, rgbs, relposes, _ = _example_05()
    want = jax_filter(edges, weights, landmarks, rgbs, relposes,
                      min_shared=35, verbose=True)
    ref_out = capsys.readouterr().out
    got = relpose_filter(edges, weights, landmarks, rgbs, relposes,
                         min_shared=35, verbose=True)
    assert capsys.readouterr().out == ref_out
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))
