"""Files and state shared between ``xmtpu`` and ``xmtpu_torch``: the
``.bin`` format through the reference's file entry points, the ``.npz``
checkpoints in both directions, and the numpy mapping of solver state
(``xmtpu_torch.convert``).

Resumed solves run the same f64 recurrences from the same state, so they
take the same decisions and reach primals equal to 1e-10 relative, or
1e-12 absolute at these near-zero optima (the objective is a difference of
O(1) terms).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import XM as j_XM
from xmtpu.assembly.creatematrix import create_matrix_arrays
from xmtpu.io.bin_format import load_matrix_from_bin, save_matrix_to_bin
from xmtpu.ops import manifold as jmf
from xmtpu.pipeline.synthetic import make_scene
from xmtpu.solver import checkpoint as jck
from xmtpu.solver import trust_region as jtr
from xmtpu.solver.staircase import solve_arrays as j_solve
from xmtpu_torch import XM as t_XM
from xmtpu_torch import convert
from xmtpu_torch.io import bin_format as tbin
from xmtpu_torch.solver import checkpoint as tck
from xmtpu_torch.solver import trust_region as ttr
from xmtpu_torch.solver.staircase import solve_arrays as t_solve


@pytest.fixture(scope="module")
def C():
    sc = make_scene(n_cameras=10, n_points=40, obs_per_camera=12, noise=1e-3,
                    seed=13)
    C, _ = create_matrix_arrays(sc.weights, sc.edges, sc.landmarks)
    return np.array(C)


def test_bin_format_is_shared(tmp_path):
    A = np.random.default_rng(0).normal(size=(7, 5))
    save_matrix_to_bin(str(tmp_path / "a.bin"), A)
    tbin.save_matrix_to_bin(str(tmp_path / "b.bin"), A)
    assert (tmp_path / "a.bin").read_bytes() == (tmp_path / "b.bin").read_bytes()
    B, rows = tbin.load_matrix_from_bin(str(tmp_path / "a.bin"))
    np.testing.assert_array_equal(B, A)
    assert rows == 7
    v = np.arange(4.0)
    tbin.save_array_to_bin(str(tmp_path / "v.bin"), v)
    np.testing.assert_array_equal(
        tbin.load_array_from_bin(str(tmp_path / "v.bin")), v)


@pytest.mark.parametrize("entry", ["solve", "solve_rebuttle", "solve_rank3"])
def test_xm_file_round_trip(C, tmp_path, entry):
    """Q.bin in, R.bin / s.bin out, as the reference's three entry points."""
    n = C.shape[0] // 3
    for d in ("jax", "torch"):
        os.makedirs(tmp_path / d)
        save_matrix_to_bin(str(tmp_path / d / "Q.bin"), C)
        save_matrix_to_bin(str(tmp_path / d / "s_ini.bin"),
                           np.linspace(1.0, 1.2, n).reshape(-1, 1))
    out_j = getattr(j_XM, entry)(str(tmp_path / "jax"), 5, 1e-7, 0.0, 1000.0)
    kw = {"device": "cpu"}
    out_t = getattr(t_XM, entry)(str(tmp_path / "torch"), 5, 1e-7, 0.0,
                                 1000.0, **kw)
    assert out_t == out_j                  # None, or the rebuttle status
    for f in ("R.bin", "s.bin"):
        a, _ = load_matrix_from_bin(str(tmp_path / "jax" / f))
        b, _ = load_matrix_from_bin(str(tmp_path / "torch" / f))
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, atol=1e-6)
    R, _ = load_matrix_from_bin(str(tmp_path / "torch" / "R.bin"))
    blocks = R.reshape(n, 3, -1)
    np.testing.assert_allclose(blocks @ np.swapaxes(blocks, 1, 2),
                               np.broadcast_to(np.eye(3), (n, 3, 3)),
                               atol=1e-10)


def test_xmtpu_mid_stage_checkpoint_resumes_in_port(C, tmp_path):
    """A rank-3 solve killed after 6 outer iterations by ``xmtpu``; both
    packages resume the file and certify the same point."""
    ck_path = str(tmp_path / "mid.npz")
    n = C.shape[0] // 3
    partial = jtr.trust_region_solve(
        jnp.asarray(C), jmf.identity_frames(n, 3), jnp.ones((n,)), lam=0.0,
        gradtol=1e-8, cfg=jtr.TRConfig(max_outer=6, chunk=3),
        checkpoint_path=ck_path, ckpt_meta=dict(rank=3, gradtol=1e-8,
                                                lam=0.0))
    assert int(partial.done_reason) == jtr.DONE_MAX_OUTER
    ck = tck.load_checkpoint(ck_path)
    assert isinstance(ck, tck.TRCheckpoint)
    assert (ck.rank, ck.k_done) == (3, 6)
    st = tck.tr_state_from_checkpoint(ck, device="cpu")
    assert st.k == 6 and st.QsR is not None and st.R.dtype == torch.float64
    ref = j_solve(C, max_rank=4, tol=1e-8, verbose=False, resume_from=ck_path)
    got = t_solve(C, max_rank=4, tol=1e-8, verbose=False,
                  resume_from=ck_path, device="cpu")
    assert got.certified and bool(ref.certified)
    assert (got.rank, got.outer_iters, got.total_inner) == \
        (ref.rank, ref.outer_iters, ref.total_inner)
    np.testing.assert_allclose(got.primal, ref.primal, rtol=1e-10,
                               atol=1e-12)


def test_port_checkpoint_reads_in_xmtpu(C, tmp_path):
    """The port writes the mid-stage file; ``xmtpu`` loads and continues
    it to the same result as the port."""
    ck_path = str(tmp_path / "mid_t.npz")
    n = C.shape[0] // 3
    R0, s0 = np.broadcast_to(np.eye(3), (n, 3, 3)).copy(), np.ones(n)
    ttr.trust_region_solve(C, R0, s0, 0.0, 1e-8,
                           cfg=ttr.TRConfig(max_outer=4, chunk=2),
                           checkpoint_path=ck_path,
                           ckpt_meta=dict(rank=3, gradtol=1e-8, lam=0.0),
                           device="cpu")
    ck = jck.load_checkpoint(ck_path)
    assert isinstance(ck, jck.TRCheckpoint) and ck.k_done == 4
    st_j = jck.tr_state_from_checkpoint(ck)
    st_t = tck.tr_state_from_checkpoint(tck.load_checkpoint(ck_path),
                                        device="cpu")
    delta_bar = float(np.sqrt(n * 3 + n - 1))
    cfg_kw = dict(max_outer=200, chunk=50)
    ref = jtr.continue_chunks(jnp.asarray(C), st_j, 0.0, 1e-8, delta_bar,
                              jtr.TRConfig(**cfg_kw), k_done=4)
    got = ttr.continue_chunks(convert.qop_from_numpy(C, "cpu"), st_t, 0.0,
                              1e-8, delta_bar, ttr.TRConfig(**cfg_kw),
                              k_done=4)
    assert (got.done_reason, got.outer_iters, got.total_inner) == \
        (int(ref.done_reason), int(ref.outer_iters), int(ref.total_inner))
    np.testing.assert_allclose(got.primal, float(ref.primal), rtol=1e-10,
                               atol=1e-12)


def test_staircase_checkpoint_shared(C, tmp_path):
    """Between-rank files: written by one package, read by the other."""
    n = C.shape[0] // 3
    rng = np.random.default_rng(1)
    ck = jck.StaircaseCheckpoint(R=rng.normal(size=(n, 3, 4)),
                                 s_ex=np.ones(n), rank=4, gradtol=1e-7,
                                 escape_dir=rng.normal(size=3 * n), lam=0.5)
    jck.save_checkpoint(str(tmp_path / "j.npz"), ck)
    tck.save_checkpoint(str(tmp_path / "t.npz"), tck.StaircaseCheckpoint(*ck))
    for reader, path in ((tck.load_checkpoint, "j.npz"),
                         (jck.load_checkpoint, "t.npz")):
        back = reader(str(tmp_path / path))
        assert (back.rank, back.gradtol, back.lam) == (4, 1e-7, 0.5)
        np.testing.assert_array_equal(back.R, ck.R)
        np.testing.assert_array_equal(back.escape_dir, ck.escape_dir)


def test_convert_state_round_trip(C):
    n = C.shape[0] // 3
    st_j = jtr._init_state(jnp.asarray(C), jmf.identity_frames(n, 3),
                           jnp.ones((n,)), jnp.asarray(0.0),
                           jnp.asarray(4.0), jtr.TRConfig())
    st_t = convert.tr_state_from_numpy(st_j, device="cpu")
    assert isinstance(st_t, ttr.TRState)
    assert st_t.k == 0 and st_t.done is False and st_t.endreason == 6
    np.testing.assert_array_equal(st_t.QsR.numpy(), np.asarray(st_j.QsR))
    assert float(st_t.loss) == float(st_j.loss)
    back = jtr.TRState(**{f: jnp.asarray(v) if v is not None else None
                          for f, v in convert.to_numpy(st_t).items()})
    assert back.k.dtype == jnp.int32 and bool(back.done) is False
    np.testing.assert_array_equal(np.asarray(back.R), np.asarray(st_j.R))
    # a JAX solve continued by the port from the mapped state
    res_j = jtr.continue_chunks(jnp.asarray(C), st_j, 0.0, 1e-8, 4.0,
                                jtr.TRConfig(max_outer=100))
    res_t = ttr.continue_chunks(convert.qop_from_numpy(C, "cpu"), st_t, 0.0,
                                1e-8, 4.0, ttr.TRConfig(max_outer=100))
    assert res_t.outer_iters == int(res_j.outer_iters)
    np.testing.assert_allclose(res_t.primal, float(res_j.primal),
                               rtol=1e-10, atol=1e-12)
    mapped = convert.tr_state_from_numpy(res_j, device="cpu")
    assert isinstance(mapped, ttr.TRResult)
    np.testing.assert_allclose(mapped.R.numpy(), res_t.R.numpy(), atol=1e-8)


def test_convert_solve_result(C):
    res_j = j_solve(C, max_rank=4, tol=1e-7, verbose=False)
    res_t = convert.tr_state_from_numpy(res_j)
    assert res_t.certified == bool(res_j.certified)
    assert res_t.rank == res_j.rank and res_t.status == res_j.status
    np.testing.assert_array_equal(res_t.R, np.asarray(res_j.R))
    d = convert.to_numpy(res_t)
    assert d["status"].dtype == np.int32 and d["certified"].dtype == np.bool_
