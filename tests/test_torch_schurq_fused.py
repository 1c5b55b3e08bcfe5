"""The fused float32 product of ``SchurQ`` (``ops/schurq.py``
``schurq_product``, ``csrc/schurq.cu``) on the host: the route rule, its
plain twin against the seams bit for bit, and the wrapper's checks.  The
kernels themselves run in ``tests/test_torch_kernels.py`` on a card."""

import dataclasses

import numpy as np
import pytest
import torch

from xmtpu_torch.ops import schurq as sq
from xmtpu_torch.ops import segsum as ss
from xmtpu_torch.ops.qop import cast_qop
from xmtpu_torch.parallel.sharded import ShardedSchurQ
from xmtpu_torch.pipeline.synthetic import make_scene, make_scene_window
from xmtpu_torch.utils import timer

KINDS = [sq.SchurQ, sq.SchurQEdgeF32, sq.SchurQTF, ShardedSchurQ]


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", KINDS, ids=lambda k: k.__name__)
def test_the_route_rule(kind, dtype, device):
    want = (kind is sq.SchurQ and dtype == torch.float32
            and device == "cuda")
    assert sq.fused_route(kind, dtype, torch.device(device)) is want


# a window scene padded with phantom cameras, and a scene whose landmarks
# are each seen by all 150 cameras (their segments past CSR_LONG: the
# host plan lists them)
SCENES = {
    "window, phantom cameras": lambda: sq.pad_cameras(_build(
        make_scene_window(40, 400, 40, noise=1e-3, long_range=4, seed=0)),
        44),
    "long landmarks": lambda: _build(
        make_scene(n_cameras=150, n_points=40, obs_per_camera=60,
                   noise=1e-3, seed=1))}


def _build(sc):
    return sq.SchurQ.build(sc.weights, sc.edges, sc.landmarks, device="cpu")


@pytest.fixture(scope="module", params=sorted(SCENES))
def scene(request):
    return request.param, SCENES[request.param]()


@pytest.mark.parametrize("o", [1, 3, sq.FUSED_COLUMNS + 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_the_twin_is_the_seams_bit_for_bit(scene, dtype, o):
    """On the host the twin, and the wrapper that takes it, give the seams'
    bits in both dtypes; nothing is counted as fused and no kernel runs."""
    name, q = scene
    q = cast_qop(q, dtype)
    if name == "long landmarks":
        assert q.bounds_l.csr_plan.n_long == q.n_landmarks
    Y = torch.tensor(np.random.default_rng(o).normal(size=(q.dim, o)),
                     dtype=dtype)
    counts = (sq.schurq_product.launches, timer.applies_fused.n,
              ss.sorted_segment_sum.launches)
    seams = q.apply(Y)
    assert torch.equal(sq.schurq_product_plain(q, Y), seams)
    assert torch.equal(sq.schurq_product(q, Y), seams)
    assert (sq.schurq_product.launches, timer.applies_fused.n,
            ss.sorted_segment_sum.launches) == counts


def test_the_wrapper_checks_an_operator_once(scene):
    """The operator's tensors are checked once and cached on it while its
    fields stay the same objects; a replaced field is checked again, and an
    operator the kernels cannot take raises."""
    name, q64 = scene
    q = cast_qop(q64, torch.float32)
    a = sq._fused_args(q)
    assert sq._fused_args(q) is a
    assert (a.n, a.m) == (q.n_cameras, q.n_landmarks)
    plan = q.bounds_l.csr_plan
    assert a.n_long == plan.n_long
    if plan.n_long:
        assert a.ptr["longs"] == plan.longs.data_ptr()
        assert a.long_rows == plan.long_rows
    else:
        assert "longs" not in a.ptr
    q.cf_l = q.cf_l.clone()
    b = sq._fused_args(q)
    assert b is not a and b.ptr["cf_l"] == q.cf_l.data_ptr()
    with pytest.raises(TypeError, match="wx_l"):
        sq._fused_args(dataclasses.replace(q, wx_l=q64.wx_l))
    with pytest.raises(ValueError, match="cf_f"):
        sq._fused_args(dataclasses.replace(q, cf_f=q.cf_f[:-1]))

