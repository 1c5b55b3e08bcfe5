"""The fused-tCG CUDA kernels against their plain PyTorch twins.

This file imports neither JAX nor ``xmtpu``, so it also runs on the machine
with the card, where JAX is absent (``--noconftest`` skips the suite's
JAX set-up):

    python -m pytest tests/test_torch_kernels.py --noconftest -q

Tests that need the card carry the ``cuda`` marker and skip without one.
Kernel and twin run the same f32 recurrences with different reduction
orders: arrays agree at the Pallas suite's f32 tolerances (``atol 2e-4
scale, rtol 2e-3`` for v, ``5e-4 scale, 5e-3`` for Hv), end reason and
iteration count exactly, on these well-separated problems.
"""

import numpy as np
import pytest
import torch

from xmtpu_torch.ops import fused_tcg as ft
from xmtpu_torch.ops import manifold as mf
from xmtpu_torch.ops.qop import DenseQ
from xmtpu_torch.solver import trust_region as tr


def _inputs(n=12, o=3, seed=3, dense=True, device="cpu"):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(3 * n, 3 * n))
    C = torch.tensor(A @ A.T / (3 * n) + np.eye(3 * n), dtype=torch.float32,
                     device=device)
    R = mf.mgs_rows(torch.tensor(rng.normal(size=(n, 3, o)),
                                 dtype=torch.float32, device=device))
    s = np.abs(rng.normal(size=n)) + 0.5
    s[0] = 1.0
    s_ex = torch.tensor(s, dtype=torch.float32, device=device)
    qmul = DenseQ(C).apply if dense else (lambda Y: C @ Y)
    egR, egs, CsR = mf.egrad_csr(qmul, R, s_ex, 0.0)
    pgR, pgs = mf.project(R, s_ex[1:], egR, egs)
    gradnorm = np.float32(torch.sqrt(mf.inner(pgR, pgR, pgs, pgs,
                                              s_ex[1:])).item())
    minv = tr._build_minv(DenseQ(C).diag_blocks(), s_ex, np.float32(0.0))
    return (qmul, R, s_ex, CsR, egR, egs, pgR, pgs, gradnorm,
            np.float32(1.0), np.float32(0.0)), minv


CFG = tr.TRConfig.for_dtype(torch.float32, max_inner=25)


def _assert_loop_close(got, ref):
    assert tuple(got[4:]) == tuple(ref[4:])
    for i, (at, rt) in enumerate([(2e-4, 2e-3), (2e-4, 2e-3), (5e-4, 5e-3),
                                  (5e-4, 5e-3)]):
        g, r = got[i].cpu(), ref[i].cpu()
        scale = max(1e-3, float(r.abs().max())) if i in (0, 2) else 1.0
        torch.testing.assert_close(g, r, atol=at * scale, rtol=rt)


def test_layout_helpers():
    X = torch.tensor(np.random.default_rng(0).normal(size=(150, 3, 5)),
                     dtype=torch.float32)
    Xt = ft.to_t(X)
    assert Xt.shape == (15, 150) and Xt.is_contiguous()
    assert torch.equal(Xt[2 * 5 + 4], X[:, 2, 4])      # row k*o + j
    assert torch.equal(ft.from_t(Xt, 150, 5), X)
    v = torch.arange(1.0, 150.0)
    vs = ft.pack_s(v, 150)
    assert vs.shape == (150,) and float(vs[0]) == 0.0
    assert torch.equal(ft.unpack_s(vs, 150), v)


def test_dense_gate():
    C = torch.zeros((3 * 600, 3 * 600), dtype=torch.float32)
    assert ft.dense_matrix(DenseQ(C).apply, 600) is None         # n > 512
    assert ft.dense_matrix(lambda Y: C @ Y, 600) is None         # no DenseQ
    C = torch.zeros((3 * 512, 3 * 512), dtype=torch.float64)
    C32 = ft.dense_matrix(DenseQ(C).apply, 512)
    assert C32.dtype == torch.float32 and C32.shape == (1536, 1536)


def test_done_carry_is_a_no_op():
    """On a done carry both kernels (here their twins) leave every array
    untouched, so the host may enqueue iterations past the end."""
    args, minv = _inputs()
    const, state, sc, cfgsc = ft.prepare(*args[1:], CFG, minv)
    sc[ft.S_DONE] = 1.0
    before = [x.clone() for x in (*const.values(), *state, sc)]
    C32 = ft.dense_matrix(args[0], args[1].shape[0])
    ft.tcg_cw_dense(C32, const["Rt"], const["s_ex_t"], state[4], state[5],
                    sc, const["CWt"], 25)
    ft.tcg_step(*const.values(), *state, sc, cfgsc, 25)
    after = [*const.values(), *state, sc]
    assert all(torch.equal(a, b) for a, b in zip(before, after))


@pytest.mark.parametrize("dense", [True, False])
def test_twins_match_generic_loop(dense):
    """The plain twins, driven by ``inner_tcg_fused``, against the generic
    f32 loop of ``trust_region._inner_tcg``; no launch is counted."""
    args, minv = _inputs(o=4, seed=5, dense=dense)
    launches = (ft.tcg_step.launches, ft.tcg_cw_dense.launches)
    got = ft.inner_tcg_fused(*args, CFG, minv)
    assert (ft.tcg_step.launches, ft.tcg_cw_dense.launches) == launches
    _assert_loop_close(got, tr._inner_tcg(*args, CFG, minv=minv))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("o", [3, 5])
@pytest.mark.parametrize("dense", [True, False])
def test_kernels_match_twins_on_card(o, dense, cuda_device):
    args, minv = _inputs(o=o, dense=dense)
    ref = ft.inner_tcg_fused(*args, CFG, minv)
    args, minv = _inputs(o=o, dense=dense, device=cuda_device)
    step0, cw0 = ft.tcg_step.launches, ft.tcg_cw_dense.launches
    got = ft.inner_tcg_fused(*args, CFG, minv)
    torch.cuda.synchronize()
    assert ft.tcg_step.launches > step0
    assert (ft.tcg_cw_dense.launches > cw0) == dense
    _assert_loop_close(got, ref)


@pytest.mark.cuda
def test_one_iteration_matches_twin_on_card(cuda_device):
    out = []
    for device in ("cpu", cuda_device):
        args, minv = _inputs(o=3, device=device)
        const, state, sc, cfgsc = ft.prepare(*args[1:], CFG, minv)
        C32 = ft.dense_matrix(args[0], args[1].shape[0])
        ft.tcg_cw_dense(C32, const["Rt"], const["s_ex_t"], state[4],
                        state[5], sc, const["CWt"], 25)
        ft.tcg_step(*const.values(), *state, sc, cfgsc, 25)
        out.append((state, sc.cpu()))
    torch.cuda.synchronize()
    (s_plain, sc_plain), (s_kern, sc_kern) = out
    assert torch.equal(sc_kern[ft.S_ER:], sc_plain[ft.S_ER:])
    torch.testing.assert_close(sc_kern[:ft.S_ER], sc_plain[:ft.S_ER],
                               rtol=5e-3, atol=0.0)
    for a, b in zip(s_kern, s_plain):
        scale = max(1e-3, float(b.abs().max()))
        torch.testing.assert_close(a.cpu(), b, atol=5e-4 * scale, rtol=5e-3)


@pytest.mark.cuda
def test_wrappers_reject_bad_tensors_on_card(cuda_device):
    args, minv = _inputs(device=cuda_device)
    const, state, sc, cfgsc = ft.prepare(*args[1:], CFG, minv)
    with pytest.raises(TypeError):
        ft.tcg_step(*dict(const, Rt=const["Rt"].double()).values(), *state,
                    sc, cfgsc, 25)
    strided = const["Rt"].t().contiguous().t()         # same shape, strided
    with pytest.raises(ValueError):
        ft.tcg_step(*dict(const, Rt=strided).values(), *state, sc, cfgsc, 25)
    with pytest.raises(ValueError):
        ft.tcg_step(*dict(const, Rt=const["Rt"].cpu()).values(), *state, sc,
                    cfgsc, 25)
