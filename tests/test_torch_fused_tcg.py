"""Fused Steihaug-tCG: the plain twins of the CUDA kernels
(``xmtpu_torch.ops.fused_tcg``) against the Pallas kernels of
``xmtpu.ops.pallas_tcg`` run in interpret mode, on the same f32 inputs.

Both sides run the same recurrences in f32 with different reduction orders,
so the arrays are compared at the Pallas suite's own f32 tolerances
(``atol 2e-4 scale, rtol 2e-3`` for v, ``5e-4 scale, 5e-3`` for Hv) while
the discrete outcomes (end reason, iteration count) must be equal on these
well-separated problems.  The kernels themselves are held against the plain
twins in ``test_torch_kernels.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xmtpu.ops import manifold as jmf
from xmtpu.ops import pallas_tcg
from xmtpu.ops.qop import DenseQ as JDenseQ
from xmtpu.solver import trust_region as jtr
from xmtpu_torch.ops import fused_tcg as ft
from xmtpu_torch.ops import manifold as tmf
from xmtpu_torch.ops.qop import DenseQ as TDenseQ
from xmtpu_torch.solver import trust_region as ttr


def _problem(n=12, o=3, seed=3):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(3 * n, 3 * n))
    C = (A @ A.T / (3 * n) + np.eye(3 * n)).astype(np.float32)
    R = np.asarray(jmf.mgs_rows(jnp.asarray(rng.normal(size=(n, 3, o)),
                                            jnp.float32)))
    s_ex = (np.abs(rng.normal(size=n)) + 0.5).astype(np.float32)
    s_ex[0] = 1.0
    return C, R, s_ex


def _jax_inputs(C, R, s_ex, dense, lam=0.0):
    C, R, s_ex = jnp.asarray(C), jnp.asarray(R), jnp.asarray(s_ex)
    qmul = JDenseQ(C).apply if dense else (lambda Y: C @ Y)
    egR, egs, CsR = jmf.egrad_csr(qmul, R, s_ex, lam)
    pgR, pgs = jmf.project(R, s_ex[1:], egR, egs)
    gradnorm = jnp.sqrt(jmf.inner(pgR, pgR, pgs, pgs, s_ex[1:]))
    eye = jnp.broadcast_to(jnp.eye(3, dtype=R.dtype), (R.shape[0], 3, 3))
    minv = jtr._build_minv(eye, s_ex, jnp.asarray(lam, R.dtype))
    return (qmul, R, s_ex, CsR, egR, egs, pgR, pgs, gradnorm,
            jnp.asarray(1.0, jnp.float32), jnp.asarray(lam, jnp.float32),
            minv)


def _torch_inputs(C, R, s_ex, dense, lam=0.0, device="cpu"):
    C, R, s_ex = (torch.tensor(x, device=device) for x in (C, R, s_ex))
    qmul = TDenseQ(C).apply if dense else (lambda Y: C @ Y)
    egR, egs, CsR = tmf.egrad_csr(qmul, R, s_ex, lam)
    pgR, pgs = tmf.project(R, s_ex[1:], egR, egs)
    gradnorm = np.float32(torch.sqrt(tmf.inner(pgR, pgR, pgs, pgs,
                                               s_ex[1:])).item())
    eye = torch.eye(3, dtype=R.dtype, device=device).expand(R.shape[0], 3, 3)
    minv = ttr._build_minv(eye, s_ex, np.float32(lam))
    return (qmul, R, s_ex, CsR, egR, egs, pgR, pgs, gradnorm,
            np.float32(1.0), np.float32(lam), minv)


def _assert_loop_close(got, ref):
    vR_f, vs_f, hvR_f, hvs_f, er_f, it_f = got
    vR_r, vs_r, hvR_r, hvs_r, er_r, it_r = ref
    assert int(er_f) == int(er_r)
    assert int(it_f) == int(it_r)
    vR_r, vs_r, hvR_r, hvs_r = (np.asarray(x) for x in (vR_r, vs_r, hvR_r,
                                                        hvs_r))
    vR_f, vs_f, hvR_f, hvs_f = (x.cpu().numpy() for x in (vR_f, vs_f, hvR_f,
                                                          hvs_f))
    scale = max(1e-3, float(np.abs(vR_r).max()))
    np.testing.assert_allclose(vR_f, vR_r, atol=2e-4 * scale, rtol=2e-3)
    np.testing.assert_allclose(vs_f, vs_r, atol=2e-4, rtol=2e-3)
    hscale = max(1e-3, float(np.abs(hvR_r).max()))
    np.testing.assert_allclose(hvR_f, hvR_r, atol=5e-4 * hscale, rtol=5e-3)
    np.testing.assert_allclose(hvs_f, hvs_r, atol=5e-4, rtol=5e-3)


@pytest.mark.parametrize("o", [3, 5])
@pytest.mark.parametrize("dense", [True, False])
def test_plain_matches_pallas_interpret(o, dense, monkeypatch):
    """Both variants: dense (``qmul`` is ``DenseQ.apply``, the product inside
    ``_tcg_kernel_dense`` / ``tcg_step_dense``) and split (a plain callable,
    the product outside ``_tcg_kernel`` / ``tcg_step``)."""
    monkeypatch.setenv("XMTPU_PALLAS_TCG", "interpret")
    C, R, s_ex = _problem(o=o)
    cfg_j = jtr.TRConfig.for_dtype(jnp.float32, max_inner=25)
    cfg_t = ttr.TRConfig.for_dtype(torch.float32, max_inner=25)
    j = _jax_inputs(C, R, s_ex, dense)
    ref = pallas_tcg.inner_tcg_fused(*j[:11], cfg_j, j[11])
    t = _torch_inputs(C, R, s_ex, dense)
    assert (ft.dense_matrix(t[0], R.shape[0]) is not None) == dense
    launches = (ft.tcg_step.launches, ft.tcg_step_dense.launches)
    got = ft.inner_tcg_fused(*t[:11], cfg_t, t[11])
    # CPU tensors take the plain twins: no kernel launch is counted
    assert (ft.tcg_step.launches, ft.tcg_step_dense.launches) == launches
    _assert_loop_close(got, ref)


@pytest.mark.parametrize("o", [3, 5])
def test_plain_matches_generic_inner_loop(o):
    """The fused plain loop against the port's generic f32 ``_inner_tcg``
    loop (the route every CPU run takes)."""
    C, R, s_ex = _problem(o=o, seed=4)
    cfg = ttr.TRConfig.for_dtype(torch.float32, max_inner=25)
    t = _torch_inputs(C, R, s_ex, dense=True)
    ref = ttr._inner_tcg(*t[:11], cfg, minv=t[11])
    got = ft.inner_tcg_fused(*t[:11], cfg, t[11])
    _assert_loop_close(got, tuple(x.numpy() if isinstance(x, torch.Tensor)
                                  else x for x in ref))


def test_layout_roundtrip():
    X = torch.tensor(np.random.default_rng(0).normal(size=(150, 3, 5)),
                     dtype=torch.float32)
    Xt = ft.to_t(X)
    assert Xt.shape == (15, 150) and Xt.is_contiguous()
    assert torch.equal(ft.from_t(Xt, 150, 5), X)
    ref = np.asarray(pallas_tcg.to_t(jnp.asarray(X.numpy())))[:, :150]
    np.testing.assert_array_equal(Xt.numpy(), ref)
    v = torch.arange(1.0, 150.0)
    vs = ft.pack_s(v, 150)
    assert vs.shape == (150,) and float(vs[0]) == 0.0
    assert torch.equal(ft.unpack_s(vs, 150), v)
