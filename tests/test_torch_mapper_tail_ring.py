"""The mapper's tail stages 5-8 on ``tests/test_colmap_db.py``'s ring
database: ``xmtpu_torch`` on the host against ``xmtpu``, all four stages
on, and stage 6 or 7 left out.  Tolerances as in
``tests/test_torch_mapper_tail.py``.
"""

import numpy as np
import pytest

from tests.test_colmap_db import _ring_scene, _write_scene_db
from tests.test_torch_mapper_tail import TAIL, _solve_both


def _ring_db(tmp_path, seed, n_cams, n_pts):
    rng = np.random.default_rng(seed)
    R, t, pts, keypoints, K = _ring_scene(rng, n_cams=n_cams, n_pts=n_pts)
    db = str(tmp_path / "database.db")
    _write_scene_db(db, R, t, keypoints, 500.0, 640, 480)
    return db


def test_ring_tail_matches(tmp_path):
    _, rt = _solve_both(_ring_db(tmp_path, 7, 6, 40))
    assert rt.registered.all() and rt.cluster_ids is not None
    assert np.isfinite(rt.xyz).all(axis=1).sum() > 0.8 * rt.n_tracks
    x_c = (np.einsum("eab,eb->ea", rt.R_global[rt.obs_image],
                     rt.xyz[rt.obs_track]) + rt.t_global[rt.obs_image])
    assert (x_c[:, 2] > 0).all()
    uv = 500.0 * x_c[:, :2] / x_c[:, 2:3] + [320.0, 240.0]
    assert np.median(np.linalg.norm(uv - rt.obs_xy, axis=1)) < 1.0


@pytest.mark.parametrize("flag", ["skip_bundle_adjustment",
                                  "skip_retriangulation"])
def test_one_tail_stage_skipped_matches(tmp_path, flag):
    """Stage 6 or 7 left out while the others run (stages 5 and 8:
    ``tests/test_torch_mapper_tail_stages.py``)."""
    _solve_both(_ring_db(tmp_path, 9, 5, 30), {**TAIL, flag: True})
