"""``xmtpu_torch.parallel`` (mesh, sharded operators) against
``xmtpu.parallel`` on the scenes of ``tests/test_sharding.py``: the JAX side
on the 8-device virtual CPU mesh of ``tests/conftest.py``, the port on an
8-slot host mesh (``make_mesh(8, platform="cpu")``).

Tolerances are those of ``tests/test_sharding.py``: primals ``rtol 1e-9``
(``1e-8`` with phantom padding cameras), scales ``rtol 1e-6``, the same
certified flags.  The fully two-float stages' operator applies within
1e-6 of the JAX package's sharded one (the f32-pair noise floor); their
staircase equals the port's single-device run and lies within 25 % of the
exact optimum, which is as far as f32 noise moves its stop at tol 1e-4 in
either package (the test says why).  The port's sharded applies and segment
sums have the single-device bits (``parallel/sharded.py``), which the tests
hold exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xmtpu.assembly.creatematrix import create_matrix_arrays
from xmtpu.ops import manifold as jmf
from xmtpu.ops.schurq import SchurQ as JSchurQ
from xmtpu.parallel import mesh as jmesh
from xmtpu.pipeline.synthetic import make_scene
from xmtpu.solver import trust_region as jtr
from xmtpu.solver.staircase import solve_arrays as jsolve_arrays
from xmtpu_torch.convert import schurq_from_numpy
from xmtpu_torch.ops import manifold as tmf
from xmtpu_torch.ops.qop import as_qop, cast_qop
from xmtpu_torch.ops.schurq import SchurQ
from xmtpu_torch.parallel import mesh as tmesh
from xmtpu_torch.parallel.sharded import ShardedDenseQ, ShardedSchurQ
from xmtpu_torch.pipeline.recover import recover_XM_implicit
from xmtpu_torch.solver import trust_region as ttr
from xmtpu_torch.solver.staircase import solve_arrays

CPU = "cpu"


@pytest.fixture(scope="module")
def problem():
    # n divisible by 8 so camera blocks shard evenly
    scene = make_scene(n_cameras=16, n_points=60, obs_per_camera=30,
                       noise=1e-4, seed=91)
    C, _ = create_matrix_arrays(scene.weights, scene.edges, scene.landmarks)
    return scene, np.asarray(C)


@pytest.fixture(scope="module")
def meshes():
    return jmesh.make_mesh(8), tmesh.make_mesh(8, platform=CPU)


def _build(scene):
    args = (scene.weights, scene.edges, scene.landmarks)
    return JSchurQ.build(*args), SchurQ.build(*args, device=CPU)


def test_eight_slots_available(meshes):
    jm, tm = meshes
    assert len(jax.devices()) >= 8 and jm.devices.size == 8
    assert tm.size == 8 and tm.devices == (torch.device(CPU),) * 8
    assert tm.lead == torch.device(CPU) and tm.axis_names == ("cam",)
    with pytest.raises(ValueError, match="unknown platform"):
        tmesh.make_mesh(2, platform="tpu")


def test_sharded_solve_matches_single_device(problem, meshes):
    scene, C = problem
    jm, tm = meshes
    n = C.shape[0] // 3
    R0 = np.broadcast_to(np.eye(3), (n, 3, 3)).copy()
    s0 = np.ones(n)
    single = ttr.trust_region_solve(C, R0, s0, lam=0.0, gradtol=1e-8,
                                    device=CPU)
    shard = tmesh.solve_sharded(tm, C, R0, s0, lam=0.0, gradtol=1e-8)
    ref = jmesh.solve_sharded(jm, C, jmf.identity_frames(n, 3),
                              jnp.ones((n,)), lam=0.0, gradtol=1e-8)
    for want, s_want in ((single.primal, single.s_ex.numpy()),
                         (float(ref.primal), np.asarray(ref.s_ex))):
        np.testing.assert_allclose(shard.primal, want, rtol=1e-9,
                                   atol=1e-12)
        np.testing.assert_allclose(shard.s_ex.numpy(), s_want, rtol=1e-6)


def test_sharding_layout(problem, meshes):
    scene, C = problem
    _, tm = meshes
    n = C.shape[0] // 3
    Cs, Rs, ss = tmesh.shard_problem(tm, C, tmf.identity_frames(n, 3),
                                     np.ones(n))
    # C's rows in camera blocks, one slab a slot; the carries on the lead
    assert isinstance(Cs, ShardedDenseQ) and len(Cs.slabs) == 8
    assert [tuple(s.shape) for s in Cs.slabs] == [(6, 3 * n)] * 8
    assert Cs.slab_bytes() == [6 * 3 * n * 8] * 8
    np.testing.assert_array_equal(torch.cat(Cs.slabs).numpy(), C)
    assert Rs.shape == (n, 3, 3) and ss.shape == (n,)
    assert Rs.device == ss.device == tm.lead == Cs.device
    assert not hasattr(Cs, "C")        # no whole matrix: no dense fused tCG
    np.testing.assert_array_equal(
        Cs.diag_blocks().numpy(),
        as_qop(C).diag_blocks().numpy())
    # uneven camera counts split into runs one camera apart
    uneven = tmesh.shard_problem(tmesh.make_mesh(3, platform=CPU), C,
                                 Rs, ss)[0]
    assert [s.shape[0] // 3 for s in uneven.slabs] == [6, 5, 5]
    Y = torch.as_tensor(np.random.default_rng(0).normal(size=(3 * n, 4)))
    np.testing.assert_allclose(uneven.apply(Y).numpy(), C @ Y.numpy(),
                               rtol=1e-12, atol=1e-14)


def test_sharded_operators_stay_on_their_mesh(problem, meshes):
    """A move to the lead device is the operator itself; any other raises
    instead of gathering; casts go slot by slot and clear the PSD claims."""
    scene, C = problem
    _, tm = meshes
    Cs = tmesh.shard_problem(tm, as_qop(C), np.zeros(1), np.zeros(1))[0]
    Qs = tmesh.shard_schurq(tm, _build(scene)[1])
    for q in (Cs, Qs):
        assert as_qop(q, device=CPU) is q and q.device == torch.device(CPU)
        with pytest.raises(ValueError, match="lives on its mesh"):
            as_qop(q, device="meta")
    c32 = cast_qop(Cs, torch.float32)
    assert {s.dtype for s in c32.slabs} == {torch.float32}
    assert c32.diag_blocks().dtype == torch.float32
    q32 = cast_qop(Qs, torch.float32)
    assert Qs.psd_by_construction and not q32.psd_by_construction
    assert {s.q.Q1.dtype for s in q32.slots} == {torch.float32}
    assert q32.inv_q3.dtype == torch.float32


def test_sharded_schurq_matches_single_device(problem, meshes):
    """The factored operator sharded over the mesh (each edge ordering in
    runs of whole segments, ``VT_inv`` / ``Q1`` by camera) applies with the
    single operator's bits and reproduces the single-device and the
    reference's sharded solves."""
    scene, C = problem
    jm, tm = meshes
    Qj, Qt = _build(scene)
    n = Qt.n_cameras
    Qs = tmesh.shard_schurq(tm, Qt)
    assert isinstance(Qs, ShardedSchurQ) and len(Qs.slots) == 8
    # VT_inv has n-1 = 15 rows: zero-row-padded to 16, 2 rows a slot
    assert [tuple(s.q.VT_inv.shape) for s in Qs.slots] == [(2, 15)] * 8
    np.testing.assert_array_equal(
        torch.cat([s.q.VT_inv for s in Qs.slots])[:15].numpy(),
        Qt.VT_inv.numpy())
    assert [s.cams for s in Qs.slots] == [(2 * k, 2 * k + 2)
                                          for k in range(8)]
    assert {tuple(s.q.Q1.shape) for s in Qs.slots} == {(2, 3, 3)}
    E = Qt.f_l.shape[0]
    for ids, bounds, wx in (("l_l", "bounds_l", "wx_l"),
                            ("f_f", "bounds_f", "wx_f")):
        runs = [getattr(s.q, ids) for s in Qs.slots]
        # the ordering unpadded, in slot order, no segment over two slots,
        # each run within one segment's rows of E / 8
        assert torch.equal(torch.cat(runs), getattr(Qt, ids))
        assert torch.equal(torch.cat([getattr(s.q, wx) for s in Qs.slots]),
                           getattr(Qt, wx))
        assert all(a[-1] < b[0] for a, b in zip(runs, runs[1:]))
        widest = int(np.diff(getattr(Qt, bounds).numpy()).max())
        assert all(abs(len(r) - E / 8) <= widest for r in runs)
    Y = torch.as_tensor(np.random.default_rng(1).normal(size=(3 * n, 4)))
    assert torch.equal(Qs.apply(Y), Qt.apply(Y))
    assert torch.equal(Qs.recover_y(Y), Qt.recover_y(Y))
    assert torch.equal(Qs.diag_blocks(), Qt.diag_blocks())

    R0 = np.broadcast_to(np.eye(3), (n, 3, 3)).copy()
    single = ttr.trust_region_solve(Qt, R0, np.ones(n), lam=0.0,
                                    gradtol=1e-8, device=CPU)
    shard = ttr.trust_region_solve(Qs, R0, np.ones(n), lam=0.0,
                                   gradtol=1e-8, device=CPU)
    ref = jtr.trust_region_solve(jmesh.shard_schurq(jm, Qj),
                                 jmf.identity_frames(n, 3), jnp.ones((n,)),
                                 lam=0.0, gradtol=1e-8)
    for want in (single.primal, float(ref.primal)):
        np.testing.assert_allclose(shard.primal, want, rtol=1e-9, atol=1e-12)


def test_sharded_schurq_staircase_and_edge_f32(problem, meshes):
    """Certified staircase through the sharded implicit operator, and the
    mixed-edge and fully two-float stage paths (their f32 casts and derived
    forms made slot by slot)."""
    scene, C = problem
    jm, tm = meshes
    Qj, Qt = _build(scene)
    ref = jsolve_arrays(Qj, max_rank=4, tol=1e-8, lam=0.0, verbose=False)
    single = solve_arrays(Qt, max_rank=4, tol=1e-8, lam=0.0, verbose=False,
                          device=CPU)
    shard = tmesh.solve_arrays_sharded(tm, Qt, max_rank=4, tol=1e-8, lam=0.0,
                                       verbose=False)
    assert shard.certified == bool(ref.certified) == single.certified
    assert shard.stages[-1]["cert_path"] != "dense"      # the matvec flow
    for want in (float(ref.primal), single.primal):
        np.testing.assert_allclose(shard.primal, want, rtol=1e-9, atol=1e-12)

    mix = tmesh.solve_arrays_sharded(tm, Qt, max_rank=4, tol=1e-4, lam=0.0,
                                     verbose=False, edge_f32=True,
                                     inner_f32=True)
    assert np.isfinite(mix.primal) and mix.certified == single.certified
    kw = dict(max_rank=4, tol=1e-4, lam=0.0, verbose=False, edge_tf=True,
              inner_f32=True)
    tf = tmesh.solve_arrays_sharded(tm, Qt, **kw)
    assert np.isfinite(tf.primal) and tf.certified == single.certified
    # the two-float stages' operator applies as the JAX package's sharded
    # one, to the f32-pair noise floor (1e-6 of the output's norm)
    Y = np.random.default_rng(4).normal(size=(Qt.dim, 3))
    got = tmesh.shard_schurq(tm, Qt).two_float().apply(torch.tensor(Y))
    want = np.asarray(jmesh.shard_schurq(jm, Qj).two_float(pallas=False)
                      .apply(jnp.asarray(Y)))
    assert np.linalg.norm(got.numpy() - want) / np.linalg.norm(want) < 1e-6
    # the sharding changes no bit of the two-float run ...
    tf_single = solve_arrays(Qt, device=CPU, **kw)
    assert tf.primal == tf_single.primal
    # ... whose f32 stages stop at tol 1e-4 on their noise: the JAX
    # package's own single-device run lands 21.6 % above the exact optimum
    # (its sharded run 0.9 %, inside the reference test's 1e-2), the port's
    # 17.0 %; held within 25 % of it
    np.testing.assert_allclose(tf.primal, float(ref.primal), rtol=0.25)


def test_sharded_schurq_indivisible_n_pads_cameras(meshes):
    """n % slots != 0: the camera axis is zero-extended with phantom cameras
    so Q1/V1 genuinely split, and the certified staircase reproduces the
    unsharded optimum with the padding sliced back off."""
    jm, tm = meshes
    scene = make_scene(n_cameras=21, n_points=70, obs_per_camera=25,
                       noise=1e-4, seed=17)
    Qj, Qt = _build(scene)
    Qs = tmesh.shard_schurq(tm, Qt)
    assert Qs.n_cameras == 24                       # padded to divisibility
    assert {tuple(s.q.Q1.shape) for s in Qs.slots} == {(3, 3, 3)}
    assert [tuple(s.q.VT_inv.shape) for s in Qs.slots] == [(3, 23)] * 8
    assert jmesh.shard_schurq(jm, Qj).VT_inv.shape == (24, 23)

    ref = jsolve_arrays(Qj, max_rank=4, tol=1e-8, lam=0.0, verbose=False)
    shard = tmesh.solve_arrays_sharded(tm, Qt, max_rank=4, tol=1e-8,
                                       lam=0.0, verbose=False)
    assert shard.certified == bool(ref.certified)
    assert shard.R.shape[0] == 3 * 21 and shard.s_ex.shape[0] == 21
    np.testing.assert_allclose(shard.primal, float(ref.primal), rtol=1e-8,
                               atol=1e-11)


def test_sharded_staircase_certifies(problem, meshes):
    """The certified staircase with C row-sharded over the 8-slot mesh
    (the matvec certificate: no slot holds all of C) reproduces the
    single-device certified optimum of both packages."""
    scene, C = problem
    jm, tm = meshes
    ref = jsolve_arrays(C, max_rank=4, tol=1e-8, lam=0.0, verbose=False)
    ref_shard = jmesh.solve_arrays_sharded(jm, C, max_rank=4, tol=1e-8,
                                           lam=0.0, verbose=False)
    single = solve_arrays(C, max_rank=4, tol=1e-8, lam=0.0, verbose=False,
                          device=CPU)
    shard = tmesh.solve_arrays_sharded(tm, C, max_rank=4, tol=1e-8, lam=0.0,
                                       verbose=False)
    assert shard.certified == bool(ref.certified) == single.certified
    assert shard.stages[-1]["cert_path"] != "dense"
    for want in (ref, ref_shard, single):
        np.testing.assert_allclose(shard.primal, float(want.primal),
                                   rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(shard.s_ex, np.asarray(want.s_ex),
                                   rtol=1e-6)


def test_sharded_tr_step_matches_reference(problem, meshes):
    scene, C = problem
    jm, tm = meshes
    n = C.shape[0] // 3
    R0 = np.broadcast_to(np.eye(3), (n, 3, 3)).copy()
    R1, s1, loss1 = tmesh.sharded_tr_step(tm, C, R0, np.ones(n))
    Rj, sj, lossj = jmesh.sharded_tr_step(jm, jnp.asarray(C),
                                          jmf.identity_frames(n, 3),
                                          jnp.ones((n,)))
    loss0 = float(tmf.objective(as_qop(C).apply, torch.as_tensor(R0),
                                torch.ones(n, dtype=torch.float64), 0.0))
    assert float(loss1) < loss0
    np.testing.assert_allclose(float(loss1), float(lossj), rtol=1e-9)
    np.testing.assert_allclose(R1.numpy(), np.asarray(Rj), rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(s1.numpy(), np.asarray(sj), rtol=1e-9)
    # the single-device outer step on the whole matrix: the same iterate
    Rd, sd, lossd = tmesh._one_outer_step(as_qop(C), torch.as_tensor(R0),
                                          torch.ones(n, dtype=torch.float64))
    np.testing.assert_allclose(float(loss1), float(lossd), rtol=1e-12)
    np.testing.assert_allclose(R1.numpy(), Rd.numpy(), rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("slots", [3, 8, 48])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_straddling_segment_sums_have_single_device_bits(slots, dtype):
    """Segments that straddle the even cuts ``k E / S`` (at 48 slots, 24 of
    them phantom cameras, a camera's ~40 observations over slots of 20) go
    whole to one slot, the cut moved to their start; the slots' sums have
    the single-device bits in both orderings, one sum a slot that holds
    rows, whatever the slot count."""
    from xmtpu_torch.ops.schurq import _cf_f_rows, _wx_dot_rows

    scene = make_scene(n_cameras=24, n_points=50, obs_per_camera=40,
                       noise=1e-3, seed=5)
    Qt = SchurQ.build(scene.weights, scene.edges, scene.landmarks,
                      device=CPU).cast(dtype)
    Qs = tmesh.shard_schurq(tmesh.make_mesh(slots, platform=CPU), Qt)
    E = Qt.f_l.shape[0]
    for ids in ("l_l", "f_f"):
        whole = getattr(Qt, ids).numpy()
        even = np.arange(1, slots) * E // slots
        assert (whole[even] == whole[even - 1]).any()   # straddled
        runs = [getattr(s.q, ids).numpy() for s in Qs.slots]
        assert np.array_equal(np.concatenate(runs), whole)
        heads = [r[0] for r in runs if len(r)]
        tails = [r[-1] for r in runs if len(r)]
        assert all(t < h for t, h in zip(tails, heads[1:]))
    rng = np.random.default_rng(slots)
    Yf = torch.as_tensor(rng.normal(size=(24, 9)), dtype=dtype)
    zB = torch.as_tensor(rng.normal(size=(Qt.n_landmarks, 3)), dtype=dtype)
    assert torch.equal(Qs._esum("l", _wx_dot_rows, Yf),
                       Qt._esum("l", _wx_dot_rows, Yf))
    by_frame = Qs._esum("f", _cf_f_rows, zB)        # phantom cameras: zeros
    assert torch.equal(by_frame[:24], Qt._esum("f", _cf_f_rows, zB))
    assert not by_frame[24:].any()
    held = [sum(s.segs[o][1] > 0 for o in "lf") for s in Qs.slots]
    assert Qs.stats["slot_sums"] == held
    assert slots < 48 or min(held) == 1             # a slot without frames


def test_recover_through_sharded_operator(problem, meshes):
    """Recovery asks the operator for its device (a sharded operator holds
    its tensors in slots) and gives the single operator's poses."""
    scene, C = problem
    _, tm = meshes
    Qt = _build(scene)[1]
    Qs = tmesh.shard_schurq(tm, Qt)
    res = solve_arrays(Qt, max_rank=4, tol=1e-8, verbose=False, device=CPU)
    got = recover_XM_implicit(Qs, res.R, res.s_ex, 0.0, verbose=False)
    want = recover_XM_implicit(Qt, res.R, res.s_ex, 0.0, verbose=False)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["SchurQ", "SchurQEdgeF32", "SchurQTF"])
def test_convert_carries_sharded_reference_operator(meshes, kind):
    """``shard_schurq``'s output in the JAX package (phantom cameras,
    zero-row-padded ``VT_inv``, edge leaves padded with the last id and
    zero coefficients) carried across by ``convert.schurq_from_numpy``
    applies like the reference's: the exact operator to 1e-12, as
    ``tests/test_torch_schurq.py`` holds carried operators, the f32-pair
    ones at their noise floor; sharded again by the port, with the same
    bits as carried."""
    jm, tm = meshes
    scene = make_scene(n_cameras=21, n_points=70, obs_per_camera=25,
                       noise=1e-4, seed=17)
    Qj = JSchurQ.build(scene.weights, scene.edges, scene.landmarks)
    qj = jmesh.shard_schurq(jm, Qj)
    qj = {"SchurQ": qj, "SchurQEdgeF32": qj.edge_f32(pallas=False),
          "SchurQTF": qj.two_float(pallas=False)}[kind]
    qt = schurq_from_numpy(qj, device=CPU)
    assert type(qt).__name__ == kind and qt.n_cameras == 24
    Y = np.random.default_rng(3).normal(size=(72, 4))
    got = qt.apply(torch.tensor(Y)).numpy()
    ref = np.asarray(qj.apply(jnp.asarray(Y)))
    if kind == "SchurQ":
        np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)
    else:
        # the reference's sharded f32 edge sums add per-shard partials
        # (GSPMD), in another order than one device: the f32-pair noise
        # floor, 1e-6 of the output's norm
        assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 1e-6
    qs = tmesh.shard_schurq(tm, qt)
    assert torch.equal(qs.apply(torch.tensor(Y)), qt.apply(torch.tensor(Y)))
