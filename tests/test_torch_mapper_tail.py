"""The mapper's tail stages 5-8 end to end (``global_mapper_solve`` with
every skip flag of stages 5-8 False): ``xmtpu_torch`` on the host against
``xmtpu``, on the small scene D of ``tests/test_torch_sfm_chain.py`` (24
frames, 1000 points); ``tests/test_torch_mapper_tail_ring.py`` holds the
same on ``tests/test_colmap_db.py``'s ring database.

The observation arrays, masks, clusters and track counts are equal; poses
and focals agree within 1e-6 of their scale, points within 1e-4 (stages
5-7 compound the rounding of the port's segment sums, which add in another
order where the port merges the reference's sums, over BATA's 64 x 12 CG
steps and BA's 100-step PCG loops, and a point seen over a short baseline
moves most: on scene D 13 of 2,367 point coordinates part by up to 3.6e-5
of their scale where the poses part by 2.5e-9; the two packages agree far
inside the filters' thresholds here, so no observation flips).  On scene D the port's poses must also be as close to
ground truth as the reference's.

Both scenes run with the bundle adjuster of the reference's own end-to-end
test (``tests/test_bundle_adjustment.py::test_global_mapper_full_stages``:
intrinsics fixed; at most 20 LM steps, where that test allows 40: it
converges in fewer), and scene D with one round of stage 6 (three by
default): the reference recompiles its step for every new edge count, and
the file must run well inside 40 s.  With the
focal free, this 24-frame scene is degenerate in both packages: BA walks
the focal from 600 to 2451 px and keeps 34 of 3,543 observations, and the
two packages' focals part by 2.4e-4 relative.
"""

import numpy as np

import chip_smoke
from xmtpu.pipeline import bundle_adjustment as jba
from xmtpu.pipeline import colmap_db as jdb
from xmtpu.pipeline import global_mapper as jgm
from xmtpu_torch.pipeline import bundle_adjustment as tba
from xmtpu_torch.pipeline import colmap_db as tdb
from xmtpu_torch.pipeline import global_mapper as tgm

TAIL = dict(skip_global_positioning=False, skip_bundle_adjustment=False,
            skip_retriangulation=False, skip_pruning=False)
SMALL_D = dict(n_frames=24, n_points=1000, seed=0)
RTOL = dict(xyz=1e-4)       # of the field's scale; 1e-6 for the others


def _assert_tail_matches(a, b):
    """``MapperResult``s: integers and masks equal, floats within their
    RTOL of their scale with equal NaN patterns."""
    assert a._fields == b._fields
    for name in a._fields:
        x, y = getattr(a, name), getattr(b, name)
        if name == "image_names":
            assert x == y
            continue
        assert (x is None) == (y is None), name
        if x is None:
            continue
        x, y = np.asarray(x), np.asarray(y)
        assert x.shape == y.shape, name
        if x.dtype.kind != "f":
            np.testing.assert_array_equal(y, x, err_msg=name)
            continue
        fin = np.isfinite(x)
        np.testing.assert_array_equal(np.isfinite(y), fin, err_msg=name)
        scale = max(np.abs(x[fin]).max(initial=0.0), 1.0)
        np.testing.assert_allclose(y[fin], x[fin], rtol=0,
                                   atol=RTOL.get(name, 1e-6) * scale,
                                   err_msg=name)


BUNDLE = dict(optimize_intrinsics=False, max_iterations=20)


def _solve_both(db, opts=TAIL, bundle=BUNDLE):
    """Both packages' ``global_mapper_solve`` on ``db``, held against each
    other; ``bundle``: BundleAdjusterOptions fields for both."""
    vj = jdb.database_to_view_graph(jdb.read_database(db))
    vt = tdb.database_to_view_graph(tdb.read_database(db))
    oj = jgm.GlobalMapperOptions(**opts)
    ot = tgm.GlobalMapperOptions(**opts)
    if bundle is not None:
        oj.bundle = jba.BundleAdjusterOptions(**bundle)
        ot.bundle = tba.BundleAdjusterOptions(**bundle)
    rj = jgm.global_mapper_solve(vj, oj)
    rt = tgm.global_mapper_solve(vt, ot, device="cpu")
    _assert_tail_matches(rj, rt)
    return rj, rt


def _rotation_error_deg(R_est, R_gt):
    """Per-image angle (deg) between ``R_est`` and ``R_gt`` after the best
    global rotation (cam_from_world poses: R_est_i ~ R_gt_i G)."""
    M = np.einsum("nba,nbc->ac", R_gt, R_est)
    U, _, Vt = np.linalg.svd(M)
    G = U @ np.diag([1, 1, np.linalg.det(U @ Vt)]) @ Vt
    D = np.einsum("nab,bc,ndc->nad", R_gt, G, R_est)
    c = np.clip((np.trace(D, axis1=1, axis2=2) - 1) / 2, -1, 1)
    return np.degrees(np.arccos(c))


def test_small_scene_d_tail_matches(tmp_path):
    sc = chip_smoke.make_scene_d(**SMALL_D)
    db = str(tmp_path / "scene_d.db")
    chip_smoke.write_scene_d(db, sc)
    rj, rt = _solve_both(db, {**TAIL, "num_iteration_bundle_adjustment": 1})
    assert rt.registered.all() and len(rt.obs_image) > 4000
    err_j = _rotation_error_deg(rj.R_global, sc.R)
    err_t = _rotation_error_deg(rt.R_global, sc.R)
    assert err_t.max() <= 1.0001 * err_j.max() + 1e-9
    assert err_t.max() < 0.1
