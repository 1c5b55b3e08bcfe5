"""The XM-SfM front half end to end, in both packages (as
``tests/test_colmap_io.py::test_example03_real_export_arm`` runs it for
``xmtpu``): a COLMAP database of the small scene D -> ``mapper`` ->
``parse_glomap_tempdata`` -> ``build_view_graph`` -> ``lift_dataset`` (GT
depth) -> ``xm2_solve`` -> ``metrics.evaluate``.

The port runs with ``device="cpu"``.  Held: equal tempdata; the certified
rank of the last staircase solve equal; the primal within rtol 5e-3, the
bound ``chip_smoke.py`` holds the card to; rotation errors against GT
within 1.5x the reference run's;
``metrics.evaluate`` equal to 1e-9 on the same inputs.
"""

import filecmp

import numpy as np
import pytest

import chip_smoke
from xmtpu.__main__ import main as j_main
from xmtpu.pipeline import frontend as jfe
from xmtpu.pipeline import metrics as jmet
from xmtpu.pipeline import xm2 as jxm2
from xmtpu_torch.__main__ import main as t_main
from xmtpu_torch.pipeline import frontend as tfe
from xmtpu_torch.pipeline import metrics as tmet
from xmtpu_torch.pipeline import xm2 as txm2

SMALL_D = dict(n_frames=24, n_points=1000, seed=0)
# the routes as chip_smoke.py holds them: the dense one at xm2_solve's
# defaults, the implicit one at tol=1e-4 (its stages in f64)
XM2_ARGS = chip_smoke.XM2_D_ARGS
RTOL_PRIMAL = chip_smoke.RTOL_IMPLICIT
ROT_SLACK = chip_smoke.ROT_SLACK


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """Scene D's database through each package's mapper and lifting."""
    tmp = tmp_path_factory.mktemp("chain")
    sc = chip_smoke.make_scene_d(**SMALL_D)
    db = str(tmp / "database.db")
    chip_smoke.write_scene_d(db, sc)
    out = {}
    for tag, main, fe, kw in (("j", j_main, jfe, {}),
                              ("t", t_main, tfe, {"device": "cpu"})):
        td = str(tmp / f"tempdata_{tag}")
        assert main(["mapper", "--database_path", db, "--output_path", td,
                     "--quiet"], **kw) == 0
        exp = fe.parse_glomap_tempdata(td)
        vg = fe.build_view_graph(exp.matches, N=exp.N, M=exp.M)
        lifted = fe.lift_dataset(vg, lambda i: chip_smoke.scene_d_depth(sc, i),
                                 lambda i: sc.K)
        out[tag] = dict(tempdata=td, vg=vg, lifted=lifted)
    return sc, out


def test_mapper_and_lifting_agree(chain):
    sc, out = chain
    for name in ("output.txt", "filename.txt", "relative_pose.txt"):
        assert filecmp.cmp(f"{out['j']['tempdata']}/{name}",
                           f"{out['t']['tempdata']}/{name}", shallow=False)
    for a, b in zip(out["j"]["lifted"], out["t"]["lifted"]):
        np.testing.assert_array_equal(b, a)
    assert out["t"]["vg"].N == len(sc.R)


def _xm2(xm2, lifted, vg, **kw):
    solves, orig = [], xm2.solve_arrays

    def recording(*a, **k):
        solves.append(orig(*a, **k))
        return solves[-1]

    edges, weights, landmarks = lifted
    xm2.solve_arrays = recording
    try:
        res = xm2.xm2_solve(edges.copy(), weights.copy(), landmarks.copy(),
                            np.zeros((len(landmarks), 3)), vg.N, vg.M,
                            verbose=False, **kw)
    finally:
        xm2.solve_arrays = orig
    return res, solves[-1]


def test_xm2_on_the_lifted_scene_agrees(chain):
    hold_xm2(chain, "dense")


def hold_xm2(chain, route):
    """``xm2_solve`` on ``route`` in both packages, held as the module
    docstring says (the implicit route: ``test_torch_sfm_chain_implicit``,
    a file of its own for the JAX package's compile time)."""
    sc, out = chain
    kw = XM2_ARGS[route]
    rj, last_j = _xm2(jxm2, out["j"]["lifted"], out["j"]["vg"], **kw)
    rt, last_t = _xm2(txm2, out["t"]["lifted"], out["t"]["vg"],
                      device="cpu", **kw)
    assert last_j.certified and last_t.certified
    assert last_t.rank == last_j.rank
    assert abs(last_t.primal - last_j.primal) <= RTOL_PRIMAL * last_j.primal
    R_gt = sc.R.transpose(0, 2, 1)
    ej = chip_smoke.rotation_error_stats(rj.R_real, R_gt, rj.indices_all)
    et = chip_smoke.rotation_error_stats(rt.R_real, R_gt, rt.indices_all)
    for k in ("max", "mean"):
        assert et[k] <= ROT_SLACK * ej[k], (k, et, ej)
    # the metric block, both packages on the port's poses
    R_gt_w2c = np.concatenate(list(sc.R), axis=1)
    live = rt.indices_all > -1
    assert live.all()
    order = rt.indices_all[live]
    N2 = rt.s_real.shape[0]
    Rb = rt.R_real.reshape(3, N2, 3).transpose(1, 0, 2)[order]
    args = (Rb.transpose(1, 0, 2).reshape(3, -1), rt.t_est[:, order],
            R_gt_w2c, sc.t.T)
    mj, mt = jmet.evaluate(*args), tmet.evaluate(*args)
    assert sorted(mj) == sorted(mt)
    for k in mj:
        assert abs(mt[k] - mj[k]) <= 1e-9 * max(1.0, abs(mj[k])), k
    # chip_smoke.py's report composes the same block from the scene's GT
    m = chip_smoke.scene_d_report(rt, sc)
    assert m["ATE_R_deg"] < 0.5 and m["RPE_R_deg"] < 0.5
    for k in mj:
        assert abs(m[k] - mt[k]) <= 1e-9 * max(1.0, abs(mt[k])), k
