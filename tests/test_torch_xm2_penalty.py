"""The benchmark's plain reference of the scale-penalised problem
(``portbench/pb_penalty.py``) against the program's own objective and dual
certificate (``solver/certificate.py``) at the same factors: at ``lam = 0``
and at XM^2's first-pass ``lam = |E| / N``, at the solved factor (``Z``
positive semidefinite) and at a factor off it (``Z`` indefinite, where
both read ``lam_min`` exactly).  Primal and dual agree to 1e-10 of the
primal (the primal 1e-12 absolute where it is near 0), ``lam_min`` to 1e-9
of ``C``'s largest entry; the Riemannian gradient norm the probe is judged
by to 1e-9 of the trust region's own.  Host only; the
reference imports nothing of the program."""

import os
import sys

import numpy as np
import pytest
import torch

from xmtpu_torch.assembly.creatematrix import create_matrix_arrays
from xmtpu_torch.ops import manifold as mf
from xmtpu_torch.ops.qop import DenseQ
from xmtpu_torch.ops.schurq import SchurQ
from xmtpu_torch.pipeline.synthetic import make_scene_window
from xmtpu_torch.solver.certificate import certify
from xmtpu_torch.solver.staircase import solve_arrays

BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "portbench")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

import pb_penalty  # noqa: E402
import pb_reference  # noqa: E402

CPU = torch.device("cpu")
F64 = torch.float64
BOUND = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the solves here are many small products, which
    the suite's parallel workers would otherwise crowd off the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def problem():
    sc = make_scene_window(30, 120, 12, noise=1e-3, long_range=4, seed=5)
    C, _ = create_matrix_arrays(sc.weights, sc.edges, sc.landmarks,
                                precision="f64", device=CPU)
    el = pb_reference.eliminate(sc.edges, sc.weights, sc.landmarks, sc.N,
                                sc.M, F64, CPU)
    return sc, C, el


def _factors(sc, C, lam):
    """The solved factor at ``lam`` and one off it: its frames turned by a
    seeded rotation each, its scales moved."""
    res = solve_arrays(DenseQ(C, psd_hint=True), max_rank=5, tol=1e-8,
                       lam=lam, verbose=False, device=CPU)
    assert res.certified
    rng = np.random.default_rng(11)
    n, o = sc.N, res.R.shape[1]
    R = res.R.reshape(n, 3, o)
    turn = np.linalg.qr(rng.normal(size=(n, 3, 3)))[0]
    R_off = np.einsum("nab,nbo->nao", turn, R).reshape(3 * n, o)
    s_off = res.s_ex * np.exp(0.2 * rng.normal(size=n))
    s_off[0] = 1.0
    return [(res.R, res.s_ex), (R_off, s_off)]


@pytest.mark.parametrize("penalised", [False, True])
def test_the_penalty_reference_reads_the_programs_certificate(problem,
                                                              penalised):
    sc, C, el = problem
    lam = len(sc.edges) / sc.N if penalised else 0.0
    scale = float(torch.max(torch.abs(el.C)))
    schurq = SchurQ.build(sc.weights, sc.edges, sc.landmarks, device=CPU)
    for k, (R, s_ex) in enumerate(_factors(sc, C, lam)):
        n, o = sc.N, R.shape[1]
        Rt = torch.as_tensor(R.reshape(n, 3, o))
        st = torch.as_tensor(s_ex)
        primal = float(mf.objective(DenseQ(C).apply, Rt, st, lam))
        sR = mf.flatten(mf.scale_blocks(Rt, st))
        prog = certify(C, sR, lam, primal, method="eigh", device=CPU)
        S = pb_reference.scaled_factor(R, s_ex, F64, CPU)
        gen = torch.Generator().manual_seed(3)
        ref = pb_penalty.certificate(el.C, S, lam, BOUND, gen)
        assert ref.primal == pytest.approx(primal, rel=1e-10)
        assert pb_penalty.objective(el.C, S, lam) == pytest.approx(
            primal, rel=1e-10)
        assert abs(ref.dual - prog.dual) <= 1e-10 * abs(primal)
        assert abs(ref.lam_min - prog.lam_min) <= 1e-9 * scale
        assert abs(ref.gap - prog.gap) <= 1e-10 * abs(primal) + 3 * n * (
            1e-9 * scale)
        # the matvec flow's dual on the implicit operator is the same
        flow = certify(schurq, sR, lam, primal, device=CPU)
        assert abs(ref.dual - flow.dual) <= 1e-10 * abs(primal)
        if k == 0:      # the solved factor: Z is PSD to the bound
            assert ref.psd_at and ref.lam_min > -BOUND and prog.certified
        else:
            assert not ref.psd_at and ref.lam_min < -BOUND
            assert not prog.certified


def test_the_penalty_moves_the_primal_and_the_dual(problem):
    """Off the solved factor the penalty's terms are what part the
    penalised readings from the plain reference's."""
    sc, C, el = problem
    lam = len(sc.edges) / sc.N
    R, s_ex = _factors(sc, C, lam)[1]
    S = pb_reference.scaled_factor(R, s_ex, F64, CPU)
    x = (S.reshape(sc.N, 3, -1)[:, 0, :] ** 2).sum(-1)
    plain = pb_reference.certificate(el.C, S, BOUND,
                                     torch.Generator().manual_seed(3))
    pen = pb_penalty.certificate(el.C, S, 0.0, BOUND,
                                 torch.Generator().manual_seed(3))
    assert pen == plain
    got = pb_penalty.objective(el.C, S, lam)
    assert got == pytest.approx(plain.primal + lam * float(
        ((x - 1) ** 2).sum()), rel=1e-12)
    assert got > plain.primal


@pytest.mark.parametrize("penalised", [False, True])
def test_the_gradient_norm_is_the_one_the_trust_region_stops_on(problem,
                                                                 penalised):
    """``pb_penalty.gradnorm`` against the trust region's own norm
    (``ops/manifold.py``: the Euclidean gradient, its tangent projection,
    the Riemannian inner product) at a factor off the solved one."""
    sc, C, el = problem
    lam = len(sc.edges) / sc.N if penalised else 0.0
    R, s_ex = _factors(sc, C, lam)[1]
    n, o = sc.N, R.shape[1]
    Rt = torch.as_tensor(R.reshape(n, 3, o))
    st = torch.as_tensor(s_ex)
    gR, gs, _ = mf.egrad_csr(DenseQ(C).apply, Rt, st, lam)
    pgR, pgs = mf.project(Rt, st[1:], gR, gs)
    prog = float(torch.sqrt(mf.inner(pgR, pgR, pgs, pgs, st[1:])))
    got = pb_penalty.gradnorm(el.C, R, s_ex, lam, CPU)
    assert prog > 1.0
    assert got == pytest.approx(prog, rel=1e-9)
