"""Peaks of one NVIDIA H100 and the bytes and operations of the port's
kernels, for their roofline shares.

The peaks are NVIDIA's published rates for the SXM part at its 700 W limit
(dense, no sparsity).  ``step_bytes_ops``, ``cw_bytes_ops``,
``dense_bytes_ops`` and ``segsum_bytes_ops`` are frozen copies of the
functions of the same names in the repository's ``chip_smoke.py``: each
input byte counted read once and each output byte written once, from the
kernels' arithmetic (``tests/test_pb_roofline.py`` holds them equal).
"""

from __future__ import annotations

PEAK_F32 = 67e12      # FLOP/s, float32 outside the tensor cores
PEAK_F64 = 34e12      # FLOP/s, float64 outside the tensor cores
PEAK_BYTES = 3.35e12  # HBM3 bytes/s
F32 = 4  # bytes


def step_bytes_ops(n: int, o: int):
    """Bytes one tcg_step must move (inputs read once, outputs written
    once) and the f32 operations it does, from the kernel's arithmetic."""
    blk, row = 3 * o * n, n
    reads = 3 * blk + 5 * row + 2 * 9 * n + 8 + 4      # const arrays, sc, cfg
    state = 4 * blk + 4 * row                           # read and written
    nbytes = F32 * (reads + 2 * state + 8)
    ops = n * (183 * o + 40)
    return nbytes, ops


def cw_bytes_ops(n: int, o: int):
    """The dense variant's product alone: C, W's inputs, CW out."""
    m = 3 * n
    nbytes = F32 * (m * m + 2 * 3 * o * n + 2 * n + 8 + 3 * o * n)
    ops = 2 * m * m * o + 3 * 3 * o * n
    return nbytes, ops


def dense_bytes_ops(n: int, o: int):
    """One ``tcg_step_dense``: ``tcg_step``'s bytes with C read once more
    (W's inputs are already among them, CWt now written instead of read),
    and both operation counts."""
    m = 3 * n
    sb, so = step_bytes_ops(n, o)
    cb, co = cw_bytes_ops(n, o)
    return sb + F32 * m * m, so + co


def segsum_bytes_ops(rows: int, S: int, D: int, item: int, idx_words: int):
    """Bytes a segment sum must move (values and ``idx_words`` int32 index
    words read once, the (S, D) output written once) and its adds."""
    return rows * D * item + idx_words * 4 + S * D * item, rows * D


def least_seconds(nbytes: float, ops: float, peak_ops: float) -> float:
    """The least time of a launch: the larger of its operations over the
    peak rate and its bytes over the HBM rate."""
    return max(ops / peak_ops, nbytes / PEAK_BYTES)


def _is_tcg(name: str, dense: bool) -> bool:
    if "tcg_step_kernel" not in name:
        return False
    is_dense = "true>" in name.replace(" ", "") or "Lb1E" in name
    return is_dense == dense


def _is_segsum(name: str) -> bool:
    return "segsum_csr" in name or "segsum_long" in name


def _profiled(rec, match, launches: int, what: str) -> "float | None":
    """Summed device seconds of the kernels ``match`` accepts, after the
    cross-check that the profiler saw every launch the wrappers counted."""
    import pb_trace

    n, ns = pb_trace.kernel_ns(rec.trace, match)
    if n != launches:
        raise RuntimeError(f"{what}: the profiler recorded {n} launches, the "
                           f"wrappers counted {launches}")
    return ns / 1e9 if n else None


def tcg_share(rec, dense: bool) -> "float | None":
    """Percent of its roofline that ``tcg_step`` (or ``tcg_step_dense``)
    reached over the window: each iteration the fused loop ran at its least
    time, over the profiler's time of all its launches."""
    fn = dense_bytes_ops if dense else step_bytes_ops
    launches = least = 0
    for (d, n, o), (count, iters) in rec.launches.tcg.items():
        if d == dense:
            launches += count
            least += iters * least_seconds(*fn(n, o), PEAK_F32)
    t = _profiled(rec, lambda nm: _is_tcg(nm, dense), launches,
                  "tcg_step_dense" if dense else "tcg_step")
    return None if t is None else 100.0 * least / t


def segsum_share(rec) -> "float | None":
    """Percent of its roofline that ``sorted_segment_sum`` reached."""
    launches = 0
    least = 0.0
    for (rows, S, D, item, idx), count in rec.launches.segsum.items():
        launches += count
        peak = PEAK_F64 if item == 8 else PEAK_F32
        least += count * least_seconds(
            *segsum_bytes_ops(rows, S, D, item, idx), peak)
    t = _profiled(rec, _is_segsum, launches, "sorted_segment_sum")
    return None if t is None else 100.0 * least / t
