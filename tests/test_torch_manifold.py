"""Product-manifold primitives: ``xmtpu_torch.ops.manifold`` against
``xmtpu.ops.manifold`` on the same f64 inputs (made with numpy from a seed).

Both sides evaluate the same formulas in float64 in a possibly different
summation order, so every result must agree to 1e-12 relative to its scale.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xmtpu.ops import manifold as jmf
from xmtpu_torch.ops import manifold as tmf

TOL = 1e-12


def _inputs(o, n=9, seed=0):
    rng = np.random.default_rng(seed + o)
    R = np.asarray(jmf.mgs_rows(jnp.asarray(rng.normal(size=(n, 3, o)))))
    s_ex = np.abs(rng.normal(size=n)) + 0.5
    s_ex[0] = 1.0
    A = rng.normal(size=(3 * n, 3 * n))
    C = A @ A.T / (3 * n)
    return dict(R=R, s_ex=s_ex, C=C,
                A=rng.normal(size=(n, 3, o)), B=rng.normal(size=(n, 3, o)),
                S=rng.normal(size=(n, 3, 3)), u=rng.normal(size=n - 1),
                w=rng.normal(size=n - 1), lam=0.7)


def _close(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * scale)


def _t(x):
    return torch.tensor(np.asarray(x), dtype=torch.float64)


def _both(name, d):
    """(jax result, torch result) of manifold function ``name``."""
    j, t = jnp.asarray, _t
    R, s_ex, C, lam = d["R"], d["s_ex"], d["C"], d["lam"]
    s = s_ex[1:]
    Cj, Ct = j(C), t(C)
    qj, qt = (lambda Y: Cj @ Y), (lambda Y: Ct @ Y)
    if name == "gram3":
        return jmf.gram3(j(d["A"]), j(d["B"])), tmf.gram3(t(d["A"]), t(d["B"]))
    if name == "apply3":
        return jmf.apply3(j(d["S"]), j(d["A"])), tmf.apply3(t(d["S"]), t(d["A"]))
    if name == "sym3":
        return jmf.sym3(j(d["S"])), tmf.sym3(t(d["S"]))
    if name == "scale_blocks":
        return jmf.scale_blocks(j(d["A"]), j(s_ex)), \
            tmf.scale_blocks(t(d["A"]), t(s_ex))
    if name == "block_dots":
        return jmf.block_dots(j(d["A"]), j(d["B"])), \
            tmf.block_dots(t(d["A"]), t(d["B"]))
    if name == "inner":
        return (jmf.inner(j(d["A"]), j(d["B"]), j(d["u"]), j(d["w"]), j(s)),
                tmf.inner(t(d["A"]), t(d["B"]), t(d["u"]), t(d["w"]), t(s)))
    if name == "project":
        return (jnp.concatenate([x.ravel() for x in jmf.project(
                    j(R), j(s), j(d["A"]), j(d["u"]))]),
                torch.cat([x.reshape(-1) for x in tmf.project(
                    t(R), t(s), t(d["A"]), t(d["u"]))]))
    if name == "mgs_rows":
        return jmf.mgs_rows(j(d["A"])), tmf.mgs_rows(t(d["A"]))
    if name == "retract":
        a = jmf.retract(j(R), j(s_ex), j(d["A"]), j(d["u"]), 0.3)
        b = tmf.retract(t(R), t(s_ex), t(d["A"]), t(d["u"]), 0.3)
        return (jnp.concatenate([x.ravel() for x in a]),
                torch.cat([x.reshape(-1) for x in b]))
    if name == "objective":
        return (jmf.objective(qj, j(R), j(s_ex), lam),
                tmf.objective(qt, t(R), t(s_ex), lam))
    if name == "egrad_csr":
        a = jmf.egrad_csr(qj, j(R), j(s_ex), lam)
        b = tmf.egrad_csr(qt, t(R), t(s_ex), lam)
        return (jnp.concatenate([x.ravel() for x in a]),
                torch.cat([x.reshape(-1) for x in b]))
    if name in ("ehess", "rhess", "ehess2rhess"):
        egR_j, egs_j, CsR_j = jmf.egrad_csr(qj, j(R), j(s_ex), lam)
        egR_t, egs_t, CsR_t = tmf.egrad_csr(qt, t(R), t(s_ex), lam)
        Ru, su = d["A"], d["u"]
        if name == "ehess":
            a = jmf.ehess(qj, j(R), j(s_ex), CsR_j, j(Ru), j(su), lam)
            b = tmf.ehess(qt, t(R), t(s_ex), CsR_t, t(Ru), t(su), lam)
        elif name == "rhess":
            a = jmf.rhess(qj, j(R), j(s_ex), CsR_j, egR_j, egs_j, j(Ru),
                          j(su), lam)
            b = tmf.rhess(qt, t(R), t(s_ex), CsR_t, egR_t, egs_t, t(Ru),
                          t(su), lam)
        else:
            a = jmf.ehess2rhess(j(d["B"]), j(d["w"]), egR_j, egs_j, j(R),
                                j(s), j(Ru), j(su))
            b = tmf.ehess2rhess(t(d["B"]), t(d["w"]), egR_t, egs_t, t(R),
                                t(s), t(Ru), t(su))
        return (jnp.concatenate([x.ravel() for x in a]),
                torch.cat([x.reshape(-1) for x in b]))
    raise KeyError(name)


FUNCS = ["gram3", "apply3", "sym3", "scale_blocks", "block_dots", "inner",
         "project", "mgs_rows", "retract", "objective", "egrad_csr", "ehess",
         "ehess2rhess", "rhess"]


@pytest.mark.parametrize("o", [3, 5])
@pytest.mark.parametrize("name", FUNCS)
def test_manifold_parity(name, o):
    a, b = _both(name, _inputs(o))
    _close(b, a)


@pytest.mark.parametrize("o", [3, 5])
def test_flatten_and_identity_frames(o):
    d = _inputs(o)
    _close(tmf.flatten(_t(d["A"])), jmf.flatten(jnp.asarray(d["A"])))
    _close(tmf.unflatten(tmf.flatten(_t(d["A"]))), d["A"])
    _close(tmf.identity_frames(9, o), jmf.identity_frames(9, o))


def test_scale_hessian_sign_follows_the_code():
    """rhs = ehs s^2 + su s egs: the reference code's '+' sign."""
    n = 4
    R = tmf.identity_frames(n, 3)
    s = torch.full((n - 1,), 2.0, dtype=torch.float64)
    z = torch.zeros((n, 3, 3), dtype=torch.float64)
    one = torch.ones((n - 1,), dtype=torch.float64)
    _, rhs = tmf.ehess2rhess(z, one, z, one, R, s, z, one)
    _close(rhs, np.full(n - 1, 4.0 + 2.0))


def test_random_tangent_is_tangent():
    gen = torch.Generator().manual_seed(0)
    d = _inputs(4)
    R, s = _t(d["R"]), _t(d["s_ex"][1:])
    vR, vs = tmf.random_tangent(gen, R, s)
    # R_i vR_i^T is skew: the symmetric part vanishes
    S = tmf.sym3(tmf.gram3(R, vR))
    assert float(S.abs().max()) < 1e-13
    assert vs.shape == s.shape
