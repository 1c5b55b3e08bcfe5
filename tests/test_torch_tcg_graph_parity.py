"""The graph route's tCG provider (``graph_step.InnerGraphs``, its
segments run eagerly on the host) against the JAX package's
``lax.while_loop`` (``xmtpu.solver.trust_region._inner_tcg``) on the same
float64 inputs, preconditioned, at ``FLAG_EVERY`` iterations a replay and
at one: the same end reason and iteration count, the step and its Hessian
product to ``test_torch_trust_region.py``'s tolerance.
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_trust_region import (_point, _scene_C, _tcg_inputs_j,
                                           _tcg_inputs_t)
from xmtpu.solver import trust_region as jtr
from xmtpu_torch.ops import fused_tcg as ft
from xmtpu_torch.ops.qop import DenseQ
from xmtpu_torch.solver import trust_region as ttr
from xmtpu_torch.solver.graph_step import InnerGraphs


@pytest.mark.parametrize("o", [3, 4])
@pytest.mark.parametrize("lam", [0.0, 0.2])
@pytest.mark.parametrize("delta", [0.3, 50.0])
def test_route_loop_matches_reference(o, lam, delta, monkeypatch):
    C = _scene_C()
    R, s_ex = _point(10, o, 2)
    j = _tcg_inputs_j(C, R, s_ex, lam, True)
    t = _tcg_inputs_t(C, R, s_ex, lam, True)
    ref = jtr._inner_tcg(*j[:9], jnp.asarray(delta), jnp.asarray(lam),
                         jtr.TRConfig(max_inner=60), minv=j[9])
    qmul, R_t, s_t, CsR, egR, egs, pgR, pgs, gn, _ = t
    q = DenseQ(torch.tensor(C))
    cfg = ttr.TRConfig(max_inner=60)
    st = ttr._init_state(q, R_t, s_t, np.float64(lam), np.float64(10.0),
                         cfg)._replace(delta=np.float64(delta))
    for every in (ft.FLAG_EVERY, 1):
        monkeypatch.setattr(ft, "FLAG_EVERY", every)
        with contextlib.closing(InnerGraphs(q, qmul, q.diag_blocks(), st,
                                            np.float64(lam), cfg)) as inner:
            got = inner.solve(st, (CsR, egR, egs, pgR, pgs), np.float64(gn))
            assert got[4] == int(ref[4]) and got[5] == int(ref[5])
            for a, b in zip(got[:4], ref[:4]):
                b = np.asarray(b)
                np.testing.assert_allclose(
                    a.numpy(), b, rtol=1e-9,
                    atol=1e-9 * max(1.0, np.abs(b).max()))
