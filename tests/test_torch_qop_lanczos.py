"""Dense Q operator and Lanczos: ``xmtpu_torch`` against ``xmtpu`` on the
same numpy inputs.

``DenseQ`` is one GEMM (f64: agreement to 1e-12 relative); the Lanczos start
vector is shared (``v0``), since ``jax.random`` bits cannot be reproduced, so
both Krylov runs see the same operator and start and agree to 1e-9 on the
eigenvalue, and on the eigenvector up to sign.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xmtpu.ops import lanczos as jl
from xmtpu.ops import qop as jq
from xmtpu_torch.ops import lanczos as tl
from xmtpu_torch.ops import qop as tq


def _sym(n3, seed=0, shift=0.0):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n3, n3))
    return A @ A.T / n3 + shift * np.eye(n3)


@pytest.mark.parametrize("o", [3, 5])
def test_dense_apply_and_diag_blocks(o):
    C = _sym(3 * 7, seed=o)
    Y = np.random.default_rng(1).normal(size=(3 * 7, o))
    jq_op, tq_op = jq.DenseQ(jnp.asarray(C)), tq.DenseQ(torch.tensor(C))
    np.testing.assert_allclose(tq_op.apply(torch.tensor(Y)).numpy(),
                               np.asarray(jq_op.apply(jnp.asarray(Y))),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(tq.q_apply(torch.tensor(C), torch.tensor(Y)),
                               np.asarray(jq.q_apply(jnp.asarray(C),
                                                     jnp.asarray(Y))),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(tq_op.diag_blocks().numpy(),
                                  np.asarray(jq_op.diag_blocks()))
    assert tq_op.dim == jq_op.dim == 21


def test_as_qop_and_cast_clears_psd_hint():
    C = _sym(9)
    op = tq.as_qop(C, device="cpu")
    assert isinstance(op, tq.DenseQ) and op.C.dtype == torch.float64
    assert tq.as_qop(op) is op
    hinted = tq.DenseQ(op.C, psd_hint=True)
    assert hinted.psd_by_construction
    c32 = tq.cast_qop(hinted, torch.float32)
    ref32 = jq.cast_qop(jq.DenseQ(jnp.asarray(C), psd_hint=True), jnp.float32)
    assert c32.C.dtype == torch.float32
    assert c32.psd_hint is False and ref32.psd_hint is False
    assert tq.cast_qop(hinted, torch.float64).psd_hint is True
    np.testing.assert_array_equal(c32.C.numpy(), np.asarray(ref32.C))


@pytest.mark.parametrize("num_iters", [24, 96])
def test_lanczos_parity_shared_v0(num_iters):
    C = _sym(60, seed=2, shift=-0.5)
    v0 = np.random.default_rng(3).normal(size=60)
    lj, vj, rj = jl.lanczos_min_eig(lambda x: jnp.asarray(C) @ x, 60,
                                    num_iters=num_iters, v0=jnp.asarray(v0))
    Ct = torch.tensor(C)
    lt, vt, rt = tl.lanczos_min_eig(lambda x: Ct @ x, 60,
                                    num_iters=num_iters, v0=torch.tensor(v0))
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-9, atol=1e-9)
    sign = np.sign(float(np.dot(vt.numpy(), np.asarray(vj))))
    np.testing.assert_allclose(sign * vt.numpy(), np.asarray(vj), atol=1e-6)
    np.testing.assert_allclose(float(rt), float(rj), atol=1e-8)
    # and both agree with the exact bottom eigenvalue once converged
    if num_iters >= 60:
        np.testing.assert_allclose(float(lt), np.linalg.eigvalsh(C)[0],
                                   rtol=1e-10, atol=1e-10)


def test_lanczos_default_start_is_seeded():
    a = tl.start_vector(30, seed=4)
    b = tl.start_vector(30, seed=4)
    assert torch.equal(a, b) and a.dtype == torch.float64
    C = torch.tensor(_sym(30, seed=5))
    lam, v, resid = tl.lanczos_min_eig_dense(C, num_iters=30)
    np.testing.assert_allclose(float(lam), np.linalg.eigvalsh(C.numpy())[0],
                               rtol=1e-10, atol=1e-10)
    assert float(resid) < 1e-8
