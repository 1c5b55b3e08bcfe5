"""Sorted segment sums (``ops/segsum.py``): the plain twin against the
reference's Pallas kernels in interpret mode, mirroring
``tests/test_pallas_segsum.py`` and its tolerances (``rtol 1e-5`` f32,
``1e-12`` f64), and the copied host helpers against the reference's, array
for array.  The CUDA kernels are held against the twin in
``tests/test_torch_kernels.py`` (on the card)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xmtpu.ops import pallas_segsum as jss
from xmtpu_torch.ops import segsum as tss


def _case(E, S, D, dtype, seed=0):
    rng = np.random.default_rng(seed)
    ids = np.sort(rng.integers(0, S, E)).astype(np.int32)
    vals = rng.normal(size=(E, D)).astype(dtype)
    return vals, ids


def _tol(dtype):
    return (dict(rtol=1e-5, atol=1e-5) if dtype == np.float32
            else dict(rtol=1e-12, atol=1e-14))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("E,S,D,seed", [(2000, 300, 3, 0), (1337, 977, 5, 3)])
def test_matches_reference_kernel(dtype, E, S, D, seed):
    """Dense ids, and ids leaving gaps with E not a multiple of the chunk."""
    vals, ids = _case(E, S, D, dtype, seed)
    band = tss.max_band(ids)
    assert band == jss.max_band(ids)
    ref = jss.sorted_segment_sum(jnp.asarray(vals), jnp.asarray(ids), S, band,
                                 interpret=True)
    got = tss.sorted_segment_sum(torch.tensor(vals), torch.tensor(ids), S,
                                 band)
    assert got.dtype == torch.from_numpy(vals).dtype and got.shape == (S, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **_tol(dtype))
    # the CSR offsets the CUDA kernel reads cover the same rows
    off = tss.segment_offsets(torch.tensor(ids), S).numpy()
    np.testing.assert_array_equal(np.diff(off), np.bincount(ids, minlength=S))


def test_max_band():
    ids = np.array([0, 0, 1, 5, 5, 9], dtype=np.int32)
    assert tss.max_band(ids, chunk=3) == jss.max_band(ids, chunk=3) >= 5


@pytest.mark.parametrize("S,chunk,sb,seed", [(100_000, 512, 2048, 7),
                                             (512, 128, 128, 11),
                                             (10_000, 512, 2048, 0)])
def test_schedule_matches_reference(S, chunk, sb, seed):
    rng = np.random.default_rng(seed)
    ids = np.sort(rng.integers(0, S, 4096)).astype(np.int32)
    for got, ref in zip(tss.plan_blocks(ids, S, chunk, sb),
                        jss.plan_blocks(ids, S, chunk, sb)):
        np.testing.assert_array_equal(got, ref)
    for got, ref in zip(tss.schedule_edges(ids, S, chunk, sb),
                        jss.schedule_edges(ids, S, chunk, sb)):
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_blocked_matches_reference_large(dtype):
    """num_segments >= 1e5, as the reference's own test."""
    E, S, D = 30000, 100_000, 3
    vals, ids = _case(E, S, D, dtype, seed=7)
    ids_s, gidx, pad, blk, first, band = tss.schedule_edges(ids, S)
    vs = vals[gidx] * ~pad[:, None]
    ref = jss.sorted_segment_sum_blocked(jnp.asarray(vs), jnp.asarray(ids_s),
                                         S, blk, first, band, interpret=True)
    got = tss.sorted_segment_sum_blocked(torch.tensor(vs),
                                         torch.tensor(ids_s), S, blk, first,
                                         band)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **_tol(dtype))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jax.ops.segment_sum(vals, ids, S)),
        **_tol(dtype))


def test_blocked_dense_segments_and_block_straddle():
    E, S, D = 4096, 512, 2
    rng = np.random.default_rng(11)
    ids = np.sort(rng.integers(0, S, E)).astype(np.int32)
    ids[:S] = np.arange(S)
    ids = np.sort(ids)
    vals = rng.normal(size=(E, D))
    ids_s, gidx, pad, blk, first, band = tss.schedule_edges(
        ids, S, chunk=128, seg_block=128)
    vs = vals[gidx] * ~pad[:, None]
    ref = jss.sorted_segment_sum_blocked(
        jnp.asarray(vs), jnp.asarray(ids_s), S, blk, first, band,
        seg_block=128, chunk=128, interpret=True)
    got = tss.sorted_segment_sum_blocked(torch.tensor(vs),
                                         torch.tensor(ids_s), S, blk, first,
                                         band, seg_block=128, chunk=128)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12)


def test_blocked_empty_blocks_zeroed():
    S = 10_000
    ids = np.asarray([5, 5, 9500], np.int32)
    vals = np.asarray([[1.0, 2.0], [3.0, 4.0], [5.0, 6.0]])
    ids_s, gidx, pad, blk, first, band = tss.schedule_edges(ids, S)
    vs = vals[gidx] * ~pad[:, None]
    out = tss.sorted_segment_sum_blocked(torch.tensor(vs),
                                         torch.tensor(ids_s), S, blk, first,
                                         band).numpy()
    ref = np.asarray(jss.sorted_segment_sum_blocked(
        jnp.asarray(vs), jnp.asarray(ids_s), S, blk, first, band,
        interpret=True))
    np.testing.assert_array_equal(out, ref)
    assert out[5].tolist() == [4.0, 6.0] and out[9500].tolist() == [5.0, 6.0]
    assert np.count_nonzero(out) == 4


def test_blocked_rejects_a_layout_of_the_wrong_length():
    vals, ids = _case(100, 50, 2, np.float64)
    with pytest.raises(ValueError, match="G\\*chunk"):
        tss.sorted_segment_sum_blocked(torch.tensor(vals), torch.tensor(ids),
                                       50, np.zeros(1, np.int32),
                                       np.ones(1, np.int32), 1)
