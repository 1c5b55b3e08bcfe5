"""The CUDA kernels (fused tCG, sorted segment sums, the fused float32
product of ``SchurQ``) against their plain PyTorch twins.

This file imports neither JAX nor ``xmtpu``, so it also runs on the machine
with the card, where JAX is absent (``--noconftest`` skips the suite's
JAX set-up):

    python -m pytest tests/test_torch_kernels.py --noconftest -q

Tests that need the card carry the ``cuda`` marker and skip without one.
Fused tCG: kernel and twin run the same f32 recurrences with different
reduction orders: arrays agree at the Pallas suite's f32 tolerances
(``atol 2e-4 scale, rtol 2e-3`` for v, ``5e-4 scale, 5e-3`` for Hv), end
reason and iteration count exactly, on these well-separated problems.
Segment sums: the kernels add each segment's rows in row order, as the
CPU twin does, so they agree to a few ulps of the absolute-sum scale
(``1e-6`` f32, ``1e-14`` f64 relative to it) and repeat bit for bit; the
CSR kernel equals the CPU twin bit for bit.
"""

import numpy as np
import pytest
import torch

from xmtpu_torch.ops import fused_tcg as ft
from xmtpu_torch.ops import manifold as mf
from xmtpu_torch.ops import segsum as ss
from xmtpu_torch.ops.qop import DenseQ, as_qop, cast_qop
from xmtpu_torch.ops.schurq import (FUSED_COLUMNS, SchurQ, pad_cameras,
                                    schurq_product, schurq_product_plain)
from xmtpu_torch.pipeline.synthetic import make_scene, make_scene_window
from xmtpu_torch.utils import timer
from xmtpu_torch.solver import trust_region as tr


def _lowrank_spd(n, rng, device, k=8):
    """A cheap SPD operator at large n: ``C = diag(d) + U U^T`` applied as
    ``d Y + U (U^T Y)``, and its (n, 3, 3) diagonal blocks."""
    d = torch.tensor(rng.uniform(1.0, 2.0, size=3 * n), dtype=torch.float32,
                     device=device)
    U = torch.tensor(rng.normal(size=(3 * n, k)) / np.sqrt(k),
                     dtype=torch.float32, device=device)
    Ub = U.reshape(n, 3, k)
    diag = Ub @ Ub.transpose(1, 2) + torch.diag_embed(d.reshape(n, 3))
    return (lambda Y: d[:, None] * Y + U @ (U.T @ Y)), diag


def _inputs(n=12, o=3, seed=3, dense=True, device="cpu"):
    """Real tCG inputs at ``n`` cameras: a formed SPD ``C`` for ``n <= 64``,
    and up to the dense gate when ``dense`` (through ``DenseQ`` when
    ``dense``), a low-rank-plus-diagonal operator above."""
    rng = np.random.default_rng(seed)
    if n <= 64 or (dense and n <= ft.DENSE_MAX_N):
        A = rng.normal(size=(3 * n, 3 * n))
        C = torch.tensor(A @ A.T / (3 * n) + np.eye(3 * n),
                         dtype=torch.float32, device=device)
        qmul = DenseQ(C).apply if dense else (lambda Y: C @ Y)
        diag = DenseQ(C).diag_blocks()
    else:
        qmul, diag = _lowrank_spd(n, rng, device)
    R = mf.mgs_rows(torch.tensor(rng.normal(size=(n, 3, o)),
                                 dtype=torch.float32, device=device))
    s = np.abs(rng.normal(size=n)) + 0.5
    s[0] = 1.0
    s_ex = torch.tensor(s, dtype=torch.float32, device=device)
    egR, egs, CsR = mf.egrad_csr(qmul, R, s_ex, 0.0)
    pgR, pgs = mf.project(R, s_ex[1:], egR, egs)
    gradnorm = np.float32(torch.sqrt(mf.inner(pgR, pgR, pgs, pgs,
                                              s_ex[1:])).item())
    minv = tr._build_minv(diag, s_ex, np.float32(0.0))
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


@pytest.mark.parametrize("o", [3, 5, 12, 32])
@pytest.mark.parametrize("n", [1, 31, 120, 129, 1000, 1934, 6144, 20001])
def test_step_geometry_covers_every_camera(n, o):
    """``tcg_step``'s geometry: one block up to ``CAMS_PER_BLOCK`` cameras,
    at most one cluster, threads within the kernel's launch bounds, no block
    without a camera, and the kernel's camera loop (thread ``t`` of block
    ``b`` takes ``b*threads + t + k*blocks*threads``) visits each camera
    exactly once."""
    blocks, threads = ft.step_geometry(n, o)
    assert 1 <= blocks <= ft.MAX_CLUSTER
    assert threads % 32 == 0 and 32 <= threads <= ft.max_threads(o)
    assert (blocks == 1) == (n <= ft.CAMS_PER_BLOCK)
    assert (blocks - 1) * threads < n
    first = np.arange(blocks * threads)
    cams = np.concatenate([np.arange(f, n, blocks * threads) for f in first])
    assert np.array_equal(np.sort(cams), np.arange(n))


def test_done_carry_is_a_no_op():
    """On a done carry both variants (here their twins) leave every array
    untouched, so the host may enqueue iterations past the end."""
    args, minv = _inputs()
    const, state, sc, cfgsc = ft.prepare(*args[1:], CFG, minv)
    sc[ft.S_DONE] = 1.0
    before = [x.clone() for x in (*const.values(), *state, sc)]
    C32 = ft.dense_matrix(args[0], args[1].shape[0])
    ft.tcg_step_dense(C32, *const.values(), *state, sc, cfgsc, 25)
    ft.tcg_step(*const.values(), *state, sc, cfgsc, 25)
    after = [*const.values(), *state, sc]
    assert all(torch.equal(a, b) for a, b in zip(before, after))


@pytest.mark.parametrize("dense", [True, False])
def test_twins_match_generic_loop(dense):
    """The plain twins, driven by ``inner_tcg_fused``, against the generic
    f32 loop of ``trust_region._inner_tcg``; no launch is counted."""
    args, minv = _inputs(o=4, seed=5, dense=dense)
    launches = (ft.tcg_step.launches, ft.tcg_step_dense.launches)
    got = ft.inner_tcg_fused(*args, CFG, minv)
    assert (ft.tcg_step.launches, ft.tcg_step_dense.launches) == launches
    _assert_loop_close(got, tr._inner_tcg(*args, CFG, minv=minv))


@pytest.mark.parametrize("o", [3, 5])
def test_dense_twin_is_product_then_step(o):
    """The dense variant's twin (the wrapper on CPU tensors) is the product
    ``tcg_cw_dense_plain`` followed by ``tcg_step_plain``, bit for bit, the
    product left in ``CWt``; no launch is counted."""
    args, minv = _inputs(n=20, o=o, seed=7)
    const, state, sc, cfgsc = ft.prepare(*args[1:], CFG, minv)
    C32 = ft.dense_matrix(args[0], 20)
    ref = ({k: v.clone() for k, v in const.items()},
           [t.clone() for t in state], sc.clone())
    n0 = ft.tcg_step_dense.launches
    ft.tcg_step_dense(C32, *const.values(), *state, sc, cfgsc, 25)
    assert ft.tcg_step_dense.launches == n0
    c, st, s = ref
    ft.tcg_cw_dense_plain(C32, c["Rt"], c["s_ex_t"], st[4], st[5], s,
                          c["CWt"], 25)
    ft.tcg_step_plain(*c.values(), *st, s, cfgsc, 25)
    assert all(torch.equal(a, b) for a, b in
               zip((*const.values(), *state, sc), (*c.values(), *st, s)))
    assert float(sc[ft.S_I]) == 1.0


def _dense_rows(o):
    """Rows a warp of the dense product streams together (``DenseRows`` of
    the kernel's ``MAXO`` instantiation for rank ``o``)."""
    maxo = 4 if o <= 4 else 8 if o <= 8 else 16 if o <= 16 else 32
    return 4 if maxo <= 4 else 2 if maxo <= 8 else 1


@pytest.mark.parametrize("o", [3, 5, 12, 32])
@pytest.mark.parametrize("n", [1, 12, 61, 120, 129, 300, 512])
def test_dense_geometry_covers_every_camera_and_row(n, o):
    """``tcg_step_dense``'s geometry: at most one cluster, threads within
    the launch bounds, shared memory within its limit, no block without a
    camera; the camera loop (block ``b`` takes ``[b*cpb, (b+1)*cpb)``,
    thread ``t`` every ``threads``-th from ``b*cpb + t``) visits each camera
    exactly once, and the product's row loop (warp ``w`` takes ``RW`` rows
    from ``3*b*cpb + w*RW``, every ``warps*RW`` rows) each row of ``C``
    exactly once, inside its block's cameras."""
    blocks, threads = ft.dense_geometry(n, o)
    assert 1 <= blocks <= ft.MAX_CLUSTER
    assert threads % 32 == 0 and 32 <= threads <= ft.max_threads(o, dense=True)
    assert ft.dense_smem_bytes(n, o, blocks, threads) <= ft.DENSE_SMEM_MAX
    cpb = -(-n // blocks)
    assert (blocks - 1) * cpb < n
    cams, rows = [], []
    rw, warps = _dense_rows(o), threads // 32
    for b in range(blocks):
        c0, c1 = b * cpb, min(n, (b + 1) * cpb)
        for t in range(threads):
            cams.extend(range(c0 + t, c1, threads))
        for w in range(warps):
            for g in range(3 * c0 + w * rw, 3 * c1, warps * rw):
                rows.extend(r for r in range(g, g + rw) if r < 3 * c1)
    assert np.array_equal(np.sort(cams), np.arange(n))
    assert np.array_equal(np.sort(rows), np.arange(3 * n))


@pytest.mark.parametrize("n,o", [(600, 32), (1200, 16), (6144, 3)])
def test_dense_geometry_raises_past_shared_memory(n, o):
    """W (3n x o) and the block's CW past a block's shared memory: the
    geometry raises instead of launching."""
    with pytest.raises(ValueError, match="shared memory"):
        ft.dense_geometry(n, o)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


# one block; several blocks (n not a multiple of their threads); the
# largest cluster
CARD_N = [12, 1000, 6001]


# the dense variant: one block; rows of 12n bytes that are not 16-byte
# aligned (n = 61); several blocks; the dense gate's n = 512
DENSE_N = [12, 61, 120, 512]


@pytest.mark.cuda
@pytest.mark.parametrize("o", [3, 5])
@pytest.mark.parametrize("n,dense", [(12, True), (12, False), (1000, False),
                                     (6001, False), (61, True), (120, True),
                                     (512, True)])
def test_kernels_match_twins_on_card(o, n, dense, cuda_device):
    """The whole loop: the dense variant launches ``tcg_step_dense`` once
    an iteration and never ``tcg_step``; the split one only ``tcg_step``."""
    args, minv = _inputs(n=n, o=o, dense=dense)
    ref = ft.inner_tcg_fused(*args, CFG, minv)
    args, minv = _inputs(n=n, o=o, dense=dense, device=cuda_device)
    step0, dense0 = ft.tcg_step.launches, ft.tcg_step_dense.launches
    got = ft.inner_tcg_fused(*args, CFG, minv)
    torch.cuda.synchronize()
    launched = ft.tcg_step.launches - step0
    launched_dense = ft.tcg_step_dense.launches - dense0
    enqueued = ft.FLAG_EVERY * -(-got[5] // ft.FLAG_EVERY)
    assert (launched, launched_dense) == ((0, enqueued) if dense
                                          else (enqueued, 0))
    _assert_loop_close(got, ref)


def _first_step(n, o, device, dense=False):
    """``prepare`` on :func:`_inputs`; with ``dense``, also the f32 ``C``,
    else ``CWt`` holds the first iteration's product (the split variant's
    ``qmul``)."""
    args, minv = _inputs(n=n, o=o, dense=dense, device=device)
    const, state, sc, cfgsc = ft.prepare(*args[1:], CFG, minv)
    if dense:
        return ft.dense_matrix(args[0], n), const, state, sc, cfgsc
    W = mf.flatten(ft.from_t(state[4] * const["s_ex_t"]
                             + const["Rt"] * state[5], n, o))
    const["CWt"].copy_(ft.to_t(mf.unflatten(2.0 * args[0](W))))
    return None, const, state, sc, cfgsc


def _launch(C32, const, state, sc, cfgsc):
    if C32 is None:
        ft.tcg_step(*const.values(), *state, sc, cfgsc, 25)
    else:
        ft.tcg_step_dense(C32, *const.values(), *state, sc, cfgsc, 25)


@pytest.mark.cuda
@pytest.mark.parametrize("o", [3, 5])
@pytest.mark.parametrize("n,dense", [(n, False) for n in CARD_N]
                         + [(n, True) for n in DENSE_N])
def test_one_iteration_matches_twin_on_card(n, o, dense, cuda_device):
    """One launch against the twin (the dense variant's product ``CWt``
    too), and a second launch on clones of the same inputs gives the same
    bits."""
    out = []
    for device in ("cpu", cuda_device):
        C32, const, state, sc, cfgsc = _first_step(n, o, device, dense)
        again = ({k: c.clone() for k, c in const.items()},
                 [t.clone() for t in state], sc.clone())
        _launch(C32, const, state, sc, cfgsc)
        out.append((const["CWt"].cpu(), state, sc.cpu()))
    _launch(C32, again[0], again[1], again[2], cfgsc)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(
        (const["CWt"], *state, sc), (again[0]["CWt"], *again[1], again[2])))
    (cw_plain, s_plain, sc_plain), (cw_kern, s_kern, sc_kern) = out
    assert torch.equal(sc_kern[ft.S_ER:], sc_plain[ft.S_ER:])
    torch.testing.assert_close(sc_kern[:ft.S_ER], sc_plain[:ft.S_ER],
                               rtol=5e-3, atol=0.0)
    for a, b in zip((cw_kern, *s_kern), (cw_plain, *s_plain)):
        scale = max(1e-3, float(b.abs().max()))
        torch.testing.assert_close(a.cpu(), b, atol=5e-4 * scale, rtol=5e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("n,dense", [(n, False) for n in CARD_N]
                         + [(n, True) for n in DENSE_N])
def test_done_carry_is_a_no_op_on_card(n, dense, cuda_device):
    """A done carry, or one at max_inner, leaves every array untouched at
    every geometry: every block returns before the first barrier (the
    dense variant before its product)."""
    for slot, value in ((ft.S_DONE, 1.0), (ft.S_I, 25.0)):
        C32, const, state, sc, cfgsc = _first_step(n, 3, cuda_device, dense)
        sc[slot] = value
        before = [x.clone() for x in (*const.values(), *state, sc)]
        n0 = ft.tcg_step.launches + ft.tcg_step_dense.launches
        _launch(C32, const, state, sc, cfgsc)
        torch.cuda.synchronize()
        assert ft.tcg_step.launches + ft.tcg_step_dense.launches == n0 + 1
        after = [*const.values(), *state, sc]
        assert all(torch.equal(a, b) for a, b in zip(before, after))


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
    C32 = ft.dense_matrix(args[0], 12)
    with pytest.raises(TypeError):
        ft.tcg_step_dense(C32.double(), *const.values(), *state, sc, cfgsc,
                          25)
    with pytest.raises(ValueError):
        ft.tcg_step_dense(C32[:-3], *const.values(), *state, sc, cfgsc, 25)


# ------------------------------------------------------ segment sums --

def _seg_case(E, S, D, dtype, seed=0, gaps=False):
    rng = np.random.default_rng(seed)
    hi = S // 3 if gaps else S          # gaps: the top two thirds stay empty
    ids = np.sort(rng.integers(0, hi, E)).astype(np.int32)
    if gaps:
        ids[::7] = ids[::7] // 2 * 2    # and every odd segment thins out
        ids = np.sort(ids)
    vals = rng.normal(size=(E, D)).astype(dtype)
    return vals, ids


def _seg_ref(vals, ids, S):
    out = np.zeros((S, vals.shape[1]), np.float64)
    np.add.at(out, ids, vals.astype(np.float64))
    return out


def _seg_tol(dtype, vals, ids, S):
    """Absolute tolerance: ulps of each segment's absolute sum."""
    scale = _seg_ref(np.abs(vals), ids, S).max()
    return (1e-6 if dtype == np.float32 else 1e-14) * max(scale, 1.0)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_segsum_twin_matches_numpy(dtype):
    vals, ids = _seg_case(3000, 700, 6, dtype, gaps=True)
    out = ss.sorted_segment_sum(torch.tensor(vals), torch.tensor(ids), 700,
                                ss.max_band(ids))
    assert out.dtype == torch.from_numpy(vals).dtype
    np.testing.assert_allclose(out.numpy(), _seg_ref(vals, ids, 700),
                               atol=_seg_tol(dtype, vals, ids, 700), rtol=0)


def test_segsum_blocked_twin_matches_numpy():
    vals, ids = _seg_case(5000, 9000, 3, np.float64, seed=2)
    ids_s, gidx, pad, blk, first, band = ss.schedule_edges(ids, 9000)
    vs = vals[gidx] * ~pad[:, None]
    out = ss.sorted_segment_sum_blocked(torch.tensor(vs), torch.tensor(ids_s),
                                        9000, blk, first, band)
    np.testing.assert_allclose(out.numpy(), _seg_ref(vals, ids, 9000),
                               atol=_seg_tol(np.float64, vals, ids, 9000),
                               rtol=0)


def test_segment_offsets():
    ids = torch.tensor([0, 0, 2, 2, 2, 5], dtype=torch.int64)
    off = ss.segment_offsets(ids, 7)
    assert off.dtype == torch.int32
    assert off.tolist() == [0, 2, 2, 5, 5, 5, 6, 6]


def _csr_layout(layout, S, seed):
    """CSR offsets ``(S+1,)`` for the CSR kernel's cases: ``landmarks`` and
    ``frames`` — ``bounds_l`` / ``bounds_f``-shaped, ~11 and ~44 rows a
    segment; ``gaps`` — two thirds of the segments empty; ``long`` — one
    segment of 5000 rows (longer than any chunk at D >= 3) among short
    ones."""
    rng = np.random.default_rng(seed)
    if layout in ("landmarks", "frames"):
        mean = 11 if layout == "landmarks" else 44
        ids = rng.integers(0, S, S * mean)
    elif layout == "gaps":
        ids = rng.integers(0, S // 3, 4 * S) * 3
    else:
        assert layout == "long"
        ids = np.concatenate([rng.integers(0, S, 3 * S),
                              np.full(5000, S // 2)])
    return np.searchsorted(np.sort(ids), np.arange(S + 1)).astype(np.int64)


def _csr_walk(vals, off, batch):
    """numpy mirror of ``segsum_csr`` in ``csrc/segsum.cu``: thread (s, d)
    loads rows ``[off[s], off[s+1])`` of column d ``batch`` at a time and
    adds each batch's rows in row order, in the values' own type, starting
    from zero.  Returns the sums and the number of batches the longest
    segment took."""
    L = np.diff(off)
    acc = np.zeros((len(L), vals.shape[1]), vals.dtype)
    batches = 0
    for b0 in range(0, int(L.max(initial=0)), batch):
        batches += 1
        x = np.zeros((batch,) + acc.shape, vals.dtype)
        for u in range(batch):                 # every load of the batch
            live = b0 + u < L
            x[u][live] = vals[off[:-1][live] + b0 + u]
        for u in range(batch):                 # then the adds, in row order
            live = (b0 + u < L)[:, None]
            acc = np.where(live, acc + x[u], acc)
    return acc, batches


@pytest.mark.parametrize("batch", [1, 16])
@pytest.mark.parametrize("D,dtype", [(3, np.float32), (18, np.float32),
                                     (3, np.float64), (18, np.float64)])
@pytest.mark.parametrize("layout,S", [("landmarks", 3000), ("frames", 1001),
                                      ("gaps", 900), ("long", 400)])
def test_csr_walk_is_the_cpu_twin(layout, S, D, dtype, batch):
    """The CSR kernel's batched walk (mirrored in numpy) on ``bounds_l`` /
    ``bounds_f``-shaped offsets, with empty segments and one segment many
    batches long, at both batches the kernel is built for: the CPU twin's
    bits, so the card must give them too; ``csr_batch`` batches only narrow
    rows of short segments, and ``csr_threads``' grid gives every output
    one thread, with at least ``CSR_MIN_BLOCKS`` blocks where the smallest
    block size allows."""
    off = _csr_layout(layout, S, seed=S + D)
    ids = np.repeat(np.arange(S), np.diff(off))
    vals = np.random.default_rng(D).normal(size=(len(ids), D)).astype(dtype)
    got, batches = _csr_walk(vals, off, batch)
    ref = ss.sorted_segment_sum(torch.tensor(vals), torch.tensor(ids), S)
    assert np.array_equal(got, ref.numpy())
    if layout == "long":
        assert batches >= 5000 // batch
    threads = ss.csr_threads(S, D)
    assert threads in ss.CSR_THREADS
    assert ss.csr_batch(len(ids), S, D) == (
        ss.CSR_BATCH if D <= ss.CSR_NARROW_D and len(ids) <= ss.CSR_SHORT * S
        else 1)
    blocks = -(-S * D // threads)
    assert (blocks - 1) * threads < S * D <= blocks * threads
    assert blocks >= min(ss.CSR_MIN_BLOCKS, -(-S * D // ss.CSR_THREADS[-1]))


@pytest.mark.cuda
@pytest.mark.parametrize("D", [3, 6, 9, 18])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_segsum_kernel_matches_twin_on_card(dtype, D, cuda_device):
    vals, ids = _seg_case(20000, 2500, D, dtype, seed=D, gaps=True)
    ref = ss.sorted_segment_sum(torch.tensor(vals), torch.tensor(ids), 2500)
    v, i = torch.tensor(vals, device=cuda_device), torch.tensor(
        ids, device=cuda_device)
    off = ss.segment_offsets(i, 2500)
    n0 = ss.sorted_segment_sum.launches
    a = ss.sorted_segment_sum(v, i, 2500, offsets=off)
    b = ss.sorted_segment_sum(v, i, 2500, offsets=off)
    torch.cuda.synchronize()
    assert ss.sorted_segment_sum.launches == n0 + 2
    assert torch.equal(a, b)                      # same bits every run
    assert torch.equal(a.cpu(), ref)              # the CPU twin's bits
    assert int((a[ref.abs().sum(1) == 0] != 0).sum()) == 0   # empty segments
    np.testing.assert_allclose(a.cpu().numpy(), ref.numpy(),
                               atol=_seg_tol(dtype, vals, ids, 2500), rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("unaligned", [False, True])
@pytest.mark.parametrize("layout,S", [("landmarks", 3000), ("frames", 1001),
                                      ("gaps", 900), ("long", 400)])
@pytest.mark.parametrize("D", [3, 18])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_segsum_kernel_layouts_on_card(dtype, D, layout, S, unaligned,
                                       cuda_device):
    """Segments longer than a chunk, empty segments, the operator's two
    orderings, and values that do not start on a 16-byte boundary (a view
    one row into its storage): the CPU twin's bits, twice."""
    off = _csr_layout(layout, S, seed=S + D)
    ids = np.repeat(np.arange(S), np.diff(off)).astype(np.int32)
    rng = np.random.default_rng(D)
    full = rng.normal(size=(len(ids) + 1, D)).astype(dtype)
    vals = full[1:] if unaligned else full[:-1]
    ref = ss.sorted_segment_sum(torch.tensor(vals), torch.tensor(ids), S)
    v = torch.tensor(full, device=cuda_device)
    v = v[1:] if unaligned else v[:-1]
    assert (v.data_ptr() % 16 != 0) == (unaligned and D * vals.itemsize % 16
                                        != 0)
    o = torch.tensor(off, dtype=torch.int32, device=cuda_device)
    i = torch.tensor(ids, device=cuda_device)
    a = ss.sorted_segment_sum(v, i, S, offsets=o)
    b = ss.sorted_segment_sum(v, i, S, offsets=o)
    torch.cuda.synchronize()
    assert torch.equal(a, b) and torch.equal(a.cpu(), ref)


def _tail_layout(layout, seed=0):
    """Segment ids of the mapper's tail stages at scene D's size, in edge
    order: ``image`` — 200 images of about 1,300 observations each, sorted
    (BA's image sums; stage 4 emits observations by image); ``one`` — one
    segment of 259k rows (the longest image-sorted sum the shape allows);
    ``track`` — 7,381 tracks of about 40 observations, in image order, so
    the sum gathers through a permutation (BA's and triangulation's track
    sums, BATA's sums over points); and the LM refinement's at scene D's
    size: ``refine frame`` — 87,817 observations sorted into 200 frames
    (its ``J^T y`` camera sums), ``refine landmark`` — the same rows into
    4,366 landmarks in frame order (its point sums)."""
    rng = np.random.default_rng(seed)
    if layout == "refine frame":
        return np.sort(rng.integers(0, 200, 87_817)), 200
    if layout == "refine landmark":
        return rng.integers(0, 4366, 87_817), 4366
    if layout == "image":
        return np.sort(rng.integers(0, 200, 259_000)), 200
    if layout == "one":
        return np.zeros(259_000, np.int64), 1
    assert layout == "track"
    return rng.integers(0, 7381, 297_217), 7381


@pytest.mark.parametrize("S,hi", [(60, 50), (70_000, 69_990)])
def test_segments_helper_is_index_add_in_edge_order(S, hi):
    """``Segments``: a stable permutation by id (none when sorted; sorted
    as 16-bit ids up to 65,536 segments, as int64 above), then the sorted
    sum: on the host the bits of ``index_add_`` over the edges in their own
    order, any trailing shape, empty segments zero.  An id outside
    ``[0, S)``, which would wrap in 16 bits and leave the ids unsorted,
    raises on either path."""
    rng = np.random.default_rng(1)
    ids = rng.integers(0, hi, 3000)
    ids[ids == 7] = 8                                   # an empty segment
    vals = torch.tensor(rng.normal(size=(3000, 3, 3)))
    seg = ss.Segments(ids, S, "cpu")
    assert torch.equal(seg.perm, torch.tensor(np.argsort(ids,
                                                         kind="stable")))
    ref = torch.zeros(S, 3, 3, dtype=torch.float64).index_add_(
        0, torch.tensor(ids), vals)
    assert torch.equal(seg.sum(vals), ref)
    assert seg.offsets.dtype == torch.int32
    assert seg.offsets.tolist() == np.searchsorted(
        np.sort(ids), np.arange(S + 1)).tolist()
    s_sorted = ss.Segments(np.sort(ids), S, "cpu")
    assert s_sorted.perm is None and seg.perm is not None
    empty = ss.Segments(np.zeros(0, np.int64), 4, "cpu")
    assert torch.equal(empty.sum(torch.zeros(0, 6, dtype=torch.float64)),
                       torch.zeros(4, 6, dtype=torch.float64))
    for bad in (-1, S):
        with pytest.raises(ValueError, match="outside"):
            ss.Segments(np.append(ids, bad), S, "cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("layout,D", [("image", 6), ("image", 9),
                                      ("image", 16), ("image", 36),
                                      ("one", 6), ("one", 36),
                                      ("track", 3), ("track", 9),
                                      ("track", 16), ("refine frame", 6),
                                      ("refine landmark", 3)])
def test_segsum_tail_shapes_on_card(layout, D, cuda_device):
    """The tail stages' and the refinement's f64 shapes: long image
    segments at D = 6 to 36, one segment of 259k rows, the track layout
    through ``Segments``' gather, the refine's frame (D = 6) and landmark
    (D = 3) sums: the CPU twin's bits, twice."""
    ids, S = _tail_layout(layout, seed=D)
    vals = np.random.default_rng(D).normal(size=(len(ids), D))
    ref = ss.Segments(ids, S, "cpu").sum(torch.tensor(vals))
    seg = ss.Segments(ids, S, cuda_device)
    v = torch.tensor(vals, device=cuda_device)
    n0 = ss.sorted_segment_sum.launches
    a, b = seg.sum(v), seg.sum(v)
    torch.cuda.synchronize()
    assert ss.sorted_segment_sum.launches == n0 + 2
    assert torch.equal(a, b) and torch.equal(a.cpu(), ref)


def _long_lengths(case, seed):
    """Segment lengths of the long-segment path's card cases: ``ring`` — one
    segment of 20,000 rows (longer than all the ring's tiles together at
    every width) among 500 short ones; ``only long`` — 40 segments of 100
    to 3,000 rows; ``mixed`` — 3,000 segments of 0 to 40 rows with 30 of
    1,000 to 2,600 (BATA's cameras among its points); ``single`` — one
    segment holding all 50,000 rows; ``empty`` — long segments between runs
    of empty ones (the first and the last segment empty)."""
    rng = np.random.default_rng(seed)
    if case == "ring":
        L = rng.integers(0, 30, 501)
        L[250] = 20_000
    elif case == "only long":
        L = rng.integers(100, 3001, 40)
    elif case == "mixed":
        L = rng.integers(0, 41, 3030)
        L[rng.choice(3030, 30, replace=False)] = rng.integers(1000, 2601, 30)
    elif case == "single":
        L = np.array([50_000])
    else:
        assert case == "empty"
        L = np.zeros(60, np.int64)
        L[5:55:7] = rng.integers(ss.CSR_LONG + 1, 900, 8)
    return L


@pytest.mark.cuda
@pytest.mark.parametrize("unaligned", [False, True])
@pytest.mark.parametrize("D", [1, 3, 6, 36, ss.LONG_MAX_D + 2])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", ["ring", "only long", "mixed", "single",
                                  "empty"])
def test_segsum_long_path_on_card(case, dtype, D, unaligned, cuda_device):
    """The long-segment path through ``Segments``' planned offsets: a
    segment longer than the ring, only long segments, a mix, one segment
    holding every row, empty segments around long ones, and values that do
    not start on a 16-byte boundary (a view one row into its storage): the
    CPU twin's bits, the same bits on a second launch, one launch a call,
    counted under the plan's layout (rows wider than ``LONG_MAX_D`` take
    the one-thread-an-output walk on the same offsets)."""
    L = _long_lengths(case, seed=D)
    ids = np.repeat(np.arange(len(L)), L)
    rng = np.random.default_rng(D)
    full = rng.normal(size=(len(ids) + 1, D)).astype(dtype)
    vals = full[1:] if unaligned else full[:-1]
    ref = ss.Segments(ids, len(L), "cpu").sum(torch.tensor(vals))
    seg = ss.Segments(ids, len(L), cuda_device, case)
    assert seg.perm is None and seg.offsets.csr_plan.n_long >= 1
    v = torch.tensor(full, device=cuda_device)
    v = v[1:] if unaligned else v[:-1]
    n0 = ss.sorted_segment_sum.launches
    key = f"{case} {'f32' if dtype == np.float32 else 'f64'} D={D}"
    k0 = ss.sorted_segment_sum.layouts.get(key, 0)
    a = seg.sum(v)
    assert ss.sorted_segment_sum.launches == n0 + 1
    b = seg.sum(v)
    torch.cuda.synchronize()
    assert ss.sorted_segment_sum.launches == n0 + 2
    assert ss.sorted_segment_sum.layouts[key] == k0 + 2
    assert torch.equal(a, b) and torch.equal(a.cpu(), ref)
    assert int((a[torch.as_tensor(L, device=cuda_device) == 0] != 0).sum()
               ) == 0


@pytest.mark.cuda
def test_segsum_long_path_rejects_a_plan_of_another_layout(cuda_device):
    """Offsets whose plan was made for other rows or segments raise instead
    of launching on a layout they do not describe."""
    seg = ss.Segments(np.repeat(np.arange(3), [10, 100, 5]), 3, cuda_device,
                      "x")
    v = torch.ones((115, 3), dtype=torch.float64, device=cuda_device)
    with pytest.raises(ValueError, match="plan"):
        ss.sorted_segment_sum(v[:114], seg.ids[:114], 3, offsets=seg.offsets)
    with pytest.raises(ValueError, match="plan"):
        ss.sorted_segment_sum(v, seg.ids, 2, offsets=seg.offsets)


def _layout_ids(layout, E, S, sb, seed):
    """Sorted segment ids for the blocked-layout cases:
    ``random`` — uniform over [0, S) (sparse when E < S: empty blocks);
    ``scene_c`` — scene C's landmark ordering in miniature, ~11 rows a
    segment, so each block spans many visits and segments straddle them;
    ``first_only`` — block 1 holds only its first id (its padding equals
    every real id), block 2 is empty, the rest random;
    ``long_run`` — one segment of E/2 rows across many visits."""
    rng = np.random.default_rng(seed)
    if layout in ("random", "scene_c"):
        return np.sort(rng.integers(0, S, E)).astype(np.int32)
    if layout == "first_only":
        ids = np.concatenate([rng.integers(0, sb, E // 3),
                              np.full(E // 3, sb),
                              rng.integers(3 * sb, S, E - 2 * (E // 3))])
        return np.sort(ids).astype(np.int32)
    assert layout == "long_run"
    ids = rng.integers(0, S, E)
    ids[: E // 2] = S // 2 + 1
    return np.sort(ids).astype(np.int32)


BLOCKED_CASES = [(30000, 100000, 512, 2048, "random"),
                 (4096, 512, 128, 128, "random"),
                 (3, 10000, 512, 2048, "random"),
                 (270336, 24576, 512, 2048, "scene_c"),
                 (20000, 8192, 128, 1024, "first_only"),
                 (20000, 3000, 128, 512, "long_run")]


def _block_lower_bound(key_at, n, key, nt, P=4):
    """numpy mirror of ``block_lower_bound`` in ``csrc/segsum.cu``: the
    first index in [0, n) whose key is >= ``key``, by rounds of ``P * nt``
    evenly spaced probes, each counting the probes below ``key``."""
    lo, hi = 0, n
    while hi > lo:
        step = -(-(hi - lo) // (P * nt))
        p = lo + np.arange(P * nt) * step
        c = int((key_at(p[p < hi]) < key).sum())
        if c == 0:
            hi = lo
        else:
            lo, hi = lo + (c - 1) * step + 1, min(lo + c * step, hi)
    return lo


def _blocked_runs(ids, S, chunk, sb, tile, nt):
    """The rows ``blocked_sum`` in ``csrc/segsum.cu`` sums for each segment,
    found as it finds them: for each bound of a tile, the first visit whose
    first id reaches it, then the rows below it in the visit before (up to
    that visit's first drop) when that visit is in the tile's block; each
    segment's run where the ids change.  ``(S, 2)`` [start, end), empty runs
    as [0, 0)."""
    G = len(ids) // chunk
    runs = np.zeros((S, 2), np.int64)
    tiles = -(-sb // tile)
    for blk in range(-(-S // sb) * tiles):
        b, t = divmod(blk, tiles)
        s0 = b * sb + t * tile
        s1 = min(s0 + tile, (b + 1) * sb, S)
        if s0 >= s1:
            continue
        r = []
        for key in (s0, s1):
            g = _block_lower_bound(lambda v: ids[v * chunk], G, key, nt)
            vis = ids[(g - 1) * chunk:g * chunk]
            if g > 0 and vis[0] // sb == b:
                drop = np.flatnonzero(vis[1:] < vis[:-1])
                d = 1 + drop[0] if len(drop) else chunk
                r.append((g - 1) * chunk + int((vis[:d] < key).sum()))
            else:
                r.append(g * chunk)
        r0, r1 = r
        q = np.arange(r0, r1)
        head = (q == r0) | (ids[np.maximum(q - 1, 0)] != ids[q])
        tail = (q == r1 - 1) | (ids[np.minimum(q + 1, len(ids) - 1)]
                                != ids[q])
        runs[ids[q[head]], 0] = q[head]
        runs[ids[q[tail]], 1] = q[tail] + 1
    return runs


@pytest.mark.parametrize("nt", [256, 5])
@pytest.mark.parametrize("E,S,chunk,sb,layout", BLOCKED_CASES)
def test_blocked_run_search_matches_brute_force(E, S, chunk, sb, layout, nt):
    """The blocked kernel's run search (mirrored in numpy; ``nt=5`` forces
    several probe rounds over the visits) on ``schedule_edges`` output: every segment's run
    holds only its own id, holds every real row of that id, and the runs
    sum the values to the brute-force segment sums."""
    ids = _layout_ids(layout, E, S, sb, seed=E)
    ids_s, gidx, pad, blk, first, band = ss.schedule_edges(
        ids, S, chunk=chunk, seg_block=sb)
    tile = 256 // 6                      # the kernel's tile at D = 6
    runs = _blocked_runs(ids_s.astype(np.int64), S, chunk, sb, tile, nt)
    lengths = runs[:, 1] - runs[:, 0]
    assert (lengths >= 0).all()
    # every row of every run, beside the segment whose run it is
    seg = np.repeat(np.arange(S), lengths)
    row = (np.arange(lengths.sum()) - np.repeat(np.cumsum(lengths) - lengths,
                                                lengths)
           + np.repeat(runs[:, 0], lengths))
    assert (ids_s[row] == seg).all()
    real = np.flatnonzero(~pad)
    owner = ids_s[real]
    assert ((real >= runs[owner, 0]) & (real < runs[owner, 1])).all()
    vals = np.random.default_rng(1).normal(size=E)
    vs = vals[gidx] * ~pad
    csum = np.concatenate([[0.0], np.cumsum(vs)])
    got = csum[runs[:, 1]] - csum[runs[:, 0]]
    want = np.zeros(S)
    np.add.at(want, ids, vals)
    np.testing.assert_allclose(got, want, atol=1e-9)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("E,S,chunk,sb,layout", BLOCKED_CASES)
def test_segsum_blocked_kernel_matches_twin_on_card(dtype, E, S, chunk, sb,
                                                    layout, cuda_device):
    """Sparse ids over many blocks, chunks straddling small blocks, a huge
    empty middle (edge-less blocks come out zero), scene C's shape, a block
    holding only its first id, and one segment across many visits; D = 6
    (the kernel's tile of 42 segments) and D = 2."""
    rng = np.random.default_rng(E)
    ids = _layout_ids(layout, E, S, sb, seed=E)
    D = 6 if layout != "random" else 2
    vals = rng.normal(size=(E, D)).astype(dtype)
    ids_s, gidx, pad, blk, first, band = ss.schedule_edges(
        ids, S, chunk=chunk, seg_block=sb)
    vs = vals[gidx] * ~pad[:, None]
    ref = ss.sorted_segment_sum_blocked(torch.tensor(vs), torch.tensor(ids_s),
                                        S, blk, first, band, sb, chunk)
    v = torch.tensor(vs, device=cuda_device)
    i = torch.tensor(ids_s, device=cuda_device)
    n0 = ss.sorted_segment_sum_blocked.launches
    a = ss.sorted_segment_sum_blocked(v, i, S, blk, first, band, sb, chunk)
    b = ss.sorted_segment_sum_blocked(v, i, S, blk, first, band, sb, chunk)
    torch.cuda.synchronize()
    assert ss.sorted_segment_sum_blocked.launches == n0 + 2
    assert torch.equal(a, b)
    np.testing.assert_allclose(a.cpu().numpy(), ref.numpy(),
                               atol=_seg_tol(dtype, vals, ids, S), rtol=0)
    assert int(torch.count_nonzero(a)) == int(torch.count_nonzero(ref))


@pytest.mark.cuda
def test_segsum_wrappers_reject_bad_tensors_on_card(cuda_device):
    vals, ids = _seg_case(100, 10, 3, np.float32)
    v = torch.tensor(vals, device=cuda_device)
    i = torch.tensor(ids, device=cuda_device)
    with pytest.raises(TypeError):
        ss.sorted_segment_sum(v.half(), i, 10)
    with pytest.raises(ValueError):
        ss.sorted_segment_sum(v.t().contiguous().t(), i, 10)
    with pytest.raises(TypeError):
        ss.sorted_segment_sum(v, i, 10, offsets=ss.segment_offsets(
            i, 10).long())


# ------------------------------------------- the implicit operator's routing --

_OPS = {"SchurQ": lambda q: q,
        "f32 cast": lambda q: cast_qop(q, torch.float32),
        "edge_f32": lambda q: q.edge_f32(),
        "two_float": lambda q: q.two_float()}


def _host_schurq():
    sc = make_scene(n_cameras=10, n_points=50, obs_per_camera=20, noise=1e-3,
                    seed=4)
    return SchurQ.build(sc.weights, sc.edges, sc.landmarks, device="cpu")


@pytest.mark.parametrize("kind", list(_OPS))
def test_schurq_host_sums_ignore_bands(kind):
    """On the host every apply takes the plain twin, with or without the
    reference's bands recorded: same bits, no launch counted."""
    q = _host_schurq()
    a, b = _OPS[kind](q), _OPS[kind](q.with_pallas())
    Y = torch.tensor(np.random.default_rng(1).normal(size=(q.dim, 3)),
                     dtype=a.Q1.dtype)
    n0 = ss.sorted_segment_sum.launches
    assert torch.equal(a.apply(Y), b.apply(Y))
    assert ss.sorted_segment_sum.launches == n0


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(_OPS))
def test_schurq_moved_to_card_takes_kernel(kind, cuda_device):
    """An operator built on the host and moved to the card (no bands) runs
    every segment sum through the kernel (the f32 cast: through the fused
    product's kernels, ``schurq_product``): launches counted, the same bits
    on two applies, and no further from the exact host apply than twice the
    same variant's host apply (1e-9 for the exact operator)."""
    exact = _host_schurq()
    q_host = _OPS[kind](exact)
    q = _OPS[kind](as_qop(exact, device=cuda_device))
    Y = torch.tensor(np.random.default_rng(1).normal(size=(q.dim, 3)),
                     dtype=q.Q1.dtype)
    n0 = ss.sorted_segment_sum.launches
    f0 = schurq_product.launches
    a = q.apply(Y.to(cuda_device))
    b = q.apply(Y.to(cuda_device))
    torch.cuda.synchronize()
    if kind == "f32 cast":
        assert schurq_product.launches == f0 + 2
        assert ss.sorted_segment_sum.launches == n0
    else:
        assert ss.sorted_segment_sum.launches >= n0 + 8
        assert schurq_product.launches == f0
    assert torch.equal(a, b)
    ref = exact.apply(Y.double())

    def rel(x):
        return float(torch.linalg.norm(x.cpu().double() - ref)
                     / torch.linalg.norm(ref))

    assert rel(a) <= 2.0 * rel(q_host.apply(Y)) + 1e-9


# ---- the fused float32 product of SchurQ on the card ---------------------

# a window scene padded with phantom cameras (empty frame segments, the
# f32 phase's operator shape), and a scene whose landmarks are each seen by
# all 150 cameras (every landmark segment longer than the plan's CSR_LONG:
# a block each)
FUSED_SCENES = {
    "window, phantom cameras": (make_scene_window, dict(
        n_cameras=40, n_points=400, obs_per_camera=40, noise=1e-3,
        long_range=4, seed=0), 44),
    "long landmarks": (make_scene, dict(
        n_cameras=150, n_points=40, obs_per_camera=60, noise=1e-3, seed=1),
        150)}
FUSED_O = [1, 3, 4, 6, FUSED_COLUMNS + 1]


@pytest.mark.cuda
@pytest.mark.parametrize("o", FUSED_O)
@pytest.mark.parametrize("scene", sorted(FUSED_SCENES))
def test_fused_schurq_product_on_card(scene, o, cuda_device):
    """The f32 cast of a whole ``SchurQ`` built on the card applies through
    ``schurq_product``: the seams' bits (the plain twin on the card, whose
    sums go through ``sorted_segment_sum``), so no further from the exact
    f64 product than twice the eager f32 product (the seams on the host,
    same Y) plus 1e-6; the same bits on two calls, and the twin's bits on a
    column-major Y; one count a product in the wrapper and in
    ``applies_fused``, no ``sorted_segment_sum`` launch;
    the exact operator, ``SchurQEdgeF32``, ``SchurQTF`` and a sharded f32
    operator take the seams and leave both counts alone."""
    from xmtpu_torch.parallel.mesh import Mesh, shard_schurq

    make, params, n_pad = FUSED_SCENES[scene]
    sc = make(**params)
    exact = pad_cameras(SchurQ.build(sc.weights, sc.edges, sc.landmarks,
                                     device=cuda_device), n_pad)
    host = pad_cameras(SchurQ.build(sc.weights, sc.edges, sc.landmarks,
                                    device="cpu"), n_pad)
    if scene == "long landmarks":
        assert exact.bounds_l.csr_plan.n_long == exact.n_landmarks
    q32 = cast_qop(exact, torch.float32)
    Y = torch.tensor(np.random.default_rng(o).normal(size=(exact.dim, o)))
    want = host.apply(Y)

    def rel(x):
        return float(torch.linalg.norm(x.cpu().double() - want)
                     / torch.linalg.norm(want))

    eager = rel(cast_qop(host, torch.float32).apply(Y.float()))
    y = Y.float().to(cuda_device)
    n0, f0, a0 = (ss.sorted_segment_sum.launches, schurq_product.launches,
                  timer.applies_fused.n)
    y_view = y.t().contiguous().t()     # the same values, column-major
    a, b, c = q32.apply(y), q32.apply(y), q32.apply(y_view)
    torch.cuda.synchronize()
    assert schurq_product.launches == f0 + 3
    assert timer.applies_fused.n == a0 + 3
    assert ss.sorted_segment_sum.launches == n0
    assert torch.equal(a, b) and a.shape == (exact.dim, o)
    assert torch.equal(a, schurq_product_plain(q32, y))
    assert torch.equal(c, schurq_product_plain(q32, y_view))
    assert rel(a) <= 2.0 * eager + 1e-6, (rel(a), eager)
    sharded = shard_schurq(Mesh([cuda_device] * 3),
                           SchurQ.build(sc.weights, sc.edges, sc.landmarks,
                                        device=cuda_device))
    for op in (exact, exact.edge_f32(), exact.two_float(),
               cast_qop(sharded, torch.float32)):
        op.apply(torch.ones((op.dim, o), dtype=op.inv_q3.dtype,
                            device=cuda_device))
    torch.cuda.synchronize()
    assert schurq_product.launches == f0 + 3
    assert timer.applies_fused.n == a0 + 3
    assert ss.sorted_segment_sum.launches > n0


# ---- sharded operators (xmtpu_torch.parallel) on the card ----------------

@pytest.mark.parametrize("kind", list(_OPS))
def test_sharded_schurq_host_twin_has_single_bits(kind):
    """Sharded over five host slots, every variant applies with the single
    operator's bits (each slot sums whole segments, in row order)."""
    from xmtpu_torch.parallel.mesh import Mesh, shard_schurq

    q = _OPS[kind](_host_schurq())
    qs = shard_schurq(Mesh(["cpu"] * 5), _host_schurq())
    qs = {"SchurQ": qs, "f32 cast": cast_qop(qs, torch.float32),
          "edge_f32": qs.edge_f32(), "two_float": qs.two_float()}[kind]
    Y = torch.tensor(np.random.default_rng(2).normal(size=(q.dim, 3)),
                     dtype=q.Q1.dtype)
    assert torch.equal(qs.apply(Y), q.apply(Y))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(_OPS))
def test_sharded_schurq_apply_on_card(kind, cuda_device):
    """Five slots on one card: every segment sum of an apply launches the
    kernel once a slot, two applies
    give the same bits, and the apply matches the host twin's sharded one
    (the kernel is the CPU twin's bits; the per-camera products and the
    ``VT_inv`` GEMM may round differently on the card)."""
    from xmtpu_torch.parallel.mesh import Mesh, shard_schurq

    def make(dev):
        qs = shard_schurq(Mesh([dev] * 5), as_qop(_host_schurq(),
                                                  device=dev))
        return {"SchurQ": qs, "f32 cast": cast_qop(qs, torch.float32),
                "edge_f32": qs.edge_f32(), "two_float": qs.two_float()}[kind]

    host, card = make(torch.device("cpu")), make(cuda_device)
    Y = torch.tensor(np.random.default_rng(1).normal(size=(host.dim, 3)),
                     dtype=host.slots[0].q.Q1.dtype)
    n0 = ss.sorted_segment_sum.launches
    a = card.apply(Y.to(cuda_device))
    b = card.apply(Y.to(cuda_device))
    torch.cuda.synchronize()
    stats = card.stats
    assert all(c > 0 for c in stats["slot_sums"])
    assert ss.sorted_segment_sum.launches - n0 == sum(stats["slot_sums"])
    assert torch.equal(a, b)
    ref = host.apply(Y)
    tol = 1e-12 if kind in ("SchurQ", "edge_f32") else 1e-5
    assert float(torch.linalg.norm(a.cpu() - ref)
                 / torch.linalg.norm(ref)) < tol


@pytest.mark.cuda
def test_kernels_launch_on_the_tensors_card(cuda_device):
    """A slab on the second card, launched while the first card is
    current, runs on its own card (the wrappers' device guard) and matches
    the twin; a launch that needs a function attribute (a cluster of more
    than 8 blocks, more than 48 KB of shared memory) runs on the second
    card after the first; one card cannot show it."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards: a launch on the second card "
                    "while the first is current")
    dev1 = torch.device("cuda", 1)
    rng = np.random.default_rng(0)
    vals = torch.tensor(rng.normal(size=(5000, 6)))
    ids = torch.tensor(np.sort(rng.integers(0, 300, size=5000)))
    with torch.cuda.device(0):
        got = ss.sorted_segment_sum(vals.to(dev1), ids.to(dev1), 300)
        torch.cuda.synchronize(dev1)
    assert got.device == dev1
    assert torch.equal(got.cpu(), ss.sorted_segment_sum_plain(vals, ids, 300))
    args, minv = _inputs(n=200, dense=False, device=dev1)
    n0 = ft.tcg_step.launches
    with torch.cuda.device(0):
        got = ft.inner_tcg_fused(*args, CFG, minv)
        torch.cuda.synchronize(dev1)
    assert ft.tcg_step.launches > n0
    args, minv = _inputs(n=200, dense=False)
    _assert_loop_close(got, ft.inner_tcg_fused(*args, CFG, minv))
    # the long-segment path on the first card, then on the second with the
    # first current: its ring takes more than 48 KB of shared memory a
    # block, which each card must allow for itself
    L = _long_lengths("mixed", seed=3)
    lids = np.repeat(np.arange(len(L)), L)
    lv = torch.tensor(np.random.default_rng(3).normal(size=(len(lids), 12)))
    want = ss.Segments(lids, len(L), "cpu").sum(lv)
    for dev in (torch.device("cuda", 0), dev1):
        seg = ss.Segments(lids, len(L), dev, "two cards")
        with torch.cuda.device(0):
            got = seg.sum(lv.to(dev))
            torch.cuda.synchronize(dev)
        assert got.device == dev and torch.equal(got.cpu(), want)
    # tcg_step over a 16-block cluster (n = 6144) and tcg_step_dense at
    # n = 512 (16 blocks; at o = 5 more than 48 KB of shared memory a
    # block): the twin, then the first card, then the second with the first
    # current; each card must allow the non-portable cluster size and the
    # shared memory for itself
    for n, o, dense in ((6144, 3, False), (512, 3, True), (512, 5, True)):
        geometry = (ft.dense_geometry if dense else ft.step_geometry)(n, o)
        assert geometry[0] == ft.MAX_CLUSTER
        outs = []
        for dev in (torch.device("cpu"), torch.device("cuda", 0), dev1):
            C32, const, state, sc, cfgsc = _first_step(n, o, dev, dense)
            with torch.cuda.device(0):
                _launch(C32, const, state, sc, cfgsc)
            assert sc.device == dev
            outs.append([t.cpu() for t in (const["CWt"], *state, sc)])
        plain, first, second = outs
        assert all(torch.equal(a, b) for a, b in zip(first, second))
        assert torch.equal(second[-1][ft.S_ER:], plain[-1][ft.S_ER:])
        torch.testing.assert_close(second[-1][:ft.S_ER], plain[-1][:ft.S_ER],
                                   rtol=5e-3, atol=0.0)
        for a, b in zip(second[:-1], plain[:-1]):
            scale = max(1e-3, float(b.abs().max()))
            torch.testing.assert_close(a, b, atol=5e-4 * scale, rtol=5e-3)


# the dense assembly: scene A of chip_smoke.py (short frame sums), a scene
# whose cameras see ~200 landmarks each (long frame sums), and one whose
# edges come shuffled, a third of them twice (the repeat with half the
# weight and a moved landmark; as tests/test_torch_assembly_segments.py),
# whose repeated (frame, landmark) pairs are summed by pair
def _assembly_scene(params):
    sc = make_scene(**params)
    return sc.weights, sc.edges, sc.landmarks


def _repeated_pairs_scene(seed=4):
    w, e, x = _assembly_scene(dict(n_cameras=30, n_points=120,
                                   obs_per_camera=8, noise=0.1, seed=3))
    rng = np.random.default_rng(seed)
    k = rng.choice(len(e), size=len(e) // 3, replace=False)
    perm = rng.permutation(len(e) + len(k))
    return (np.concatenate([w, 0.5 * w[k]])[perm],
            np.concatenate([e, e[k]])[perm],
            np.concatenate([x, x[k] + 0.01])[perm])


ASSEMBLY_SCENES = {
    "scene A": lambda: _assembly_scene(dict(
        n_cameras=120, n_points=400, obs_per_camera=10, noise=0.35, seed=1)),
    "long frames": lambda: _assembly_scene(dict(
        n_cameras=6, n_points=300, obs_per_camera=200, noise=0.1, seed=2)),
    "repeated pairs": _repeated_pairs_scene}


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["f64", "mixed"])
@pytest.mark.parametrize("scene", sorted(ASSEMBLY_SCENES))
def test_dense_assembly_repeats_on_card(scene, precision, cuda_device):
    """Two assemblies on the card give the same bits of C and Abar, their
    sums by frame (D = 13) and by landmark launched once each an assembly,
    and by pair (D = 4) where a pair repeats, and agree with the host's
    assembly within the parity tolerance (1e-10 of the largest entry in
    f64, 1e-4 in "mixed": the card's GEMMs and Cholesky solves round
    differently)."""
    from xmtpu_torch.assembly.creatematrix import create_matrix_arrays

    args = ASSEMBLY_SCENES[scene]()
    repeats = len(np.unique(args[1], axis=0)) < len(args[1])
    assert repeats == (scene == "repeated pairs")
    before = dict(ss.sorted_segment_sum.layouts)
    a = create_matrix_arrays(*args, precision=precision, device=cuda_device)
    b = create_matrix_arrays(*args, precision=precision, device=cuda_device)
    torch.cuda.synchronize()
    sfx = "f64" if precision == "f64" else "f32"
    for key, n in ((f"assembly frame {sfx} D=13", 2),
                   (f"assembly landmark {sfx} D=1", 2),
                   (f"assembly pair {sfx} D=4", 2 if repeats else 0)):
        assert (ss.sorted_segment_sum.layouts.get(key, 0)
                - before.get(key, 0)) == n
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    tol = 1e-10 if precision == "f64" else 1e-4
    for got, want in zip(a, create_matrix_arrays(*args, precision=precision,
                                                 device="cpu")):
        torch.testing.assert_close(got.cpu(), want, rtol=tol,
                                   atol=tol * float(want.abs().max()))
