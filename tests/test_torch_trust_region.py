"""Riemannian trust region: ``xmtpu_torch.solver.trust_region`` against
``xmtpu.solver.trust_region`` on the same f64 inputs.

Same recurrences in float64: the tCG loop and short solves take identical
discrete decisions (end reasons, done reasons, iteration counts) and agree
to 1e-9 in value.  The mixed f32/f64 ladder reaches the same primal to
1e-9 relative (its f32 phase rounds differently; the f64 polish settles).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xmtpu.assembly.creatematrix import create_matrix_arrays
from xmtpu.ops import manifold as jmf
from xmtpu.pipeline.synthetic import make_scene
from xmtpu.solver import trust_region as jtr
from xmtpu_torch.ops import manifold as tmf
from xmtpu_torch.ops.qop import DenseQ
from xmtpu_torch.solver import trust_region as ttr


def _scene_C(n=10, seed=0, noise=0.05):
    sc = make_scene(n_cameras=n, n_points=4 * n, obs_per_camera=12,
                    noise=noise, seed=seed)
    C, _ = create_matrix_arrays(sc.weights, sc.edges, sc.landmarks)
    return np.asarray(C)


def _point(n, o, seed):
    rng = np.random.default_rng(seed)
    R = np.asarray(jmf.mgs_rows(jnp.asarray(rng.normal(size=(n, 3, o)))))
    s_ex = np.exp(0.2 * rng.normal(size=n))
    s_ex[0] = 1.0
    return R, s_ex


def _tcg_inputs_j(C, R, s_ex, lam, precond):
    qmul = lambda Y: jnp.asarray(C) @ Y                      # noqa: E731
    R, s_ex = jnp.asarray(R), jnp.asarray(s_ex)
    egR, egs, CsR = jmf.egrad_csr(qmul, R, s_ex, lam)
    pgR, pgs = jmf.project(R, s_ex[1:], egR, egs)
    gn = jnp.sqrt(jmf.inner(pgR, pgR, pgs, pgs, s_ex[1:]))
    n = R.shape[0]
    Cd = jnp.asarray(C).reshape(n, 3, n, 3)[jnp.arange(n), :, jnp.arange(n)]
    minv = jtr._build_minv(Cd, s_ex, jnp.asarray(lam)) if precond else None
    return qmul, R, s_ex, CsR, egR, egs, pgR, pgs, gn, minv


def _tcg_inputs_t(C, R, s_ex, lam, precond):
    q = DenseQ(torch.tensor(C))
    R, s_ex = torch.tensor(R), torch.tensor(s_ex)
    egR, egs, CsR = tmf.egrad_csr(q.apply, R, s_ex, lam)
    pgR, pgs = tmf.project(R, s_ex[1:], egR, egs)
    gn = float(torch.sqrt(tmf.inner(pgR, pgR, pgs, pgs, s_ex[1:])))
    minv = (ttr._build_minv(q.diag_blocks(), s_ex, np.float64(lam))
            if precond else None)
    return q.apply, R, s_ex, CsR, egR, egs, pgR, pgs, gn, minv


@pytest.mark.parametrize("lam", [0.0, 0.5])
def test_build_minv_parity(lam):
    C = _scene_C()
    R, s_ex = _point(10, 3, 1)
    j = _tcg_inputs_j(C, R, s_ex, lam, True)[-1]
    t = _tcg_inputs_t(C, R, s_ex, lam, True)[-1]
    for a, b in zip(t, j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12,
                                   atol=1e-12)


@pytest.mark.parametrize("o", [3, 5])
@pytest.mark.parametrize("precond", [True, False])
@pytest.mark.parametrize("delta", [0.3, 50.0])
def test_inner_tcg_parity_f64(o, precond, delta):
    C = _scene_C()
    R, s_ex = _point(10, o, 2)
    lam = 0.2
    j = _tcg_inputs_j(C, R, s_ex, lam, precond)
    t = _tcg_inputs_t(C, R, s_ex, lam, precond)
    ref = jtr._inner_tcg(*j[:9], jnp.asarray(delta), jnp.asarray(lam),
                         jtr.TRConfig(max_inner=60), minv=j[9])
    got = ttr._inner_tcg(*t[:9], delta, np.float64(lam),
                         ttr.TRConfig(max_inner=60), minv=t[9])
    assert got[4] == int(ref[4]) and got[5] == int(ref[5])
    for a, b in zip(got[:4], ref[:4]):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-9,
                                   atol=1e-9 * max(1.0, np.abs(b).max()))


@pytest.mark.parametrize("precond", [True, False])
def test_trust_region_solve_parity_f64(precond):
    C = _scene_C(n=10, seed=3)
    n = C.shape[0] // 3
    R0 = np.broadcast_to(np.eye(3), (n, 3, 3)).copy()
    s0 = np.ones(n)
    cfg_j = jtr.TRConfig(max_outer=200, chunk=25, precondition=precond)
    cfg_t = ttr.TRConfig(max_outer=200, chunk=25, precondition=precond)
    ref = jtr.trust_region_solve(jnp.asarray(C), R0, s0, 0.0, 1e-8,
                                 cfg=cfg_j)
    got = ttr.trust_region_solve(C, R0, s0, 0.0, 1e-8, cfg=cfg_t,
                                 device="cpu")
    assert got.done_reason == int(ref.done_reason)
    assert got.outer_iters == int(ref.outer_iters)
    assert got.total_inner == int(ref.total_inner)
    np.testing.assert_allclose(got.primal, float(ref.primal), rtol=1e-9)
    np.testing.assert_allclose(got.R.numpy(), np.asarray(ref.R), atol=1e-7)


def test_trust_region_solve_mixed_same_primal():
    C = _scene_C(n=12, seed=4, noise=0.1)
    n = C.shape[0] // 3
    R0 = np.broadcast_to(np.eye(3), (n, 3, 3)).copy()
    s0 = np.ones(n)
    ref = jtr.trust_region_solve_mixed(jnp.asarray(C), R0, s0, 0.0, 1e-8)
    got = ttr.trust_region_solve_mixed(C, R0, s0, 0.0, 1e-8, device="cpu")
    assert got.done_reason == int(ref.done_reason)
    np.testing.assert_allclose(got.primal, float(ref.primal), rtol=1e-9)


def test_escape_linesearch_parity():
    C = _scene_C(n=10, seed=5)
    n = C.shape[0] // 3
    R, s_ex = _point(n, 4, 6)
    v = np.random.default_rng(7).normal(size=3 * n)
    Rj, fj, okj = jtr._escape_linesearch(jnp.asarray(C), jnp.asarray(R),
                                         jnp.asarray(s_ex), jnp.asarray(v),
                                         1.0, 0.0, jtr.TRConfig())
    Rt, ft_, okt = ttr._escape_linesearch(DenseQ(torch.tensor(C)),
                                          torch.tensor(R), torch.tensor(s_ex),
                                          torch.tensor(v), 1.0, 0.0,
                                          ttr.TRConfig())
    assert okt == bool(okj)
    np.testing.assert_allclose(float(ft_), float(fj), rtol=1e-12)
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-12)


def test_history_table_matches(capsys):
    """``history`` rows print the reference's per-iteration table."""
    C = _scene_C(n=8, seed=1)
    n = C.shape[0] // 3
    R0 = np.broadcast_to(np.eye(3), (n, 3, 3)).copy()
    kw = dict(max_outer=6, chunk=6, history=6)
    jtr.trust_region_solve(jnp.asarray(C), R0, np.ones(n), 0.0, 1e-12,
                           cfg=jtr.TRConfig(**kw), verbose=2)
    ref = capsys.readouterr().out
    ttr.trust_region_solve(C, R0, np.ones(n), 0.0, 1e-12,
                           cfg=ttr.TRConfig(**kw), verbose=2, device="cpu")
    got = capsys.readouterr().out
    assert got.count("[tr] k=") == ref.count("[tr] k=") == 6
    # columns: k, inner iterations, status and end reason
    strip = lambda s: [(ln.split()[1:4], ln.split()[-2:])   # noqa: E731
                       for ln in s.splitlines() if ln.startswith("[tr]")]
    assert strip(got) == strip(ref)


def test_config_for_dtype_and_ladder():
    for mod, f32 in ((ttr, torch.float32), (jtr, jnp.float32)):
        cfg = mod.TRConfig.for_dtype(f32, max_inner=7)
        assert (cfg.rdotr_min, cfg.delta_min, cfg.max_inner) == (1e-7, 1e-18,
                                                                  7)
    c32, g32 = ttr.TRConfig(max_inner=500).f32_ladder(1e-8)
    r32, rg32 = jtr.TRConfig(max_inner=500).f32_ladder(1e-8)
    assert g32 == rg32 == 1e-5
    assert (c32.max_inner, c32.stop_on_collapse, c32.rdotr_min) == \
        (r32.max_inner, r32.stop_on_collapse, r32.rdotr_min)
    assert [ttr.auto_chunk(n) for n in (100, 3000, 5000)] == \
        [jtr.auto_chunk(n) for n in (100, 3000, 5000)]
