"""Implicit Schur-complement Q operator: apply C without materializing it.

PyTorch counterpart of ``xmtpu/ops/schurq.py`` (see that module for the
derivation and the reference line map).  The operator keeps the factored
form

    C Y = Q1 Y - Vtp_bar ( Mbar^{-1} ( Vtp_bar^T Y ) )

with the translation/landmark block solved exactly through the explicit
inverse ``VT_inv`` of the camera Schur complement ``VT = diag(q2_bar) -
V3F V3F^T``.  Per apply: O(E o) edge gathers and sorted segment sums plus
one (n-1)^2 GEMM.

Edge arrays are kept in two sorted orderings (by landmark, by frame) with
their CSR boundaries ``bounds_l`` / ``bounds_f`` (made by
``segsum.planned_offsets`` in :meth:`SchurQ.build`, so they carry the
kernel's plan of their long segments).  Every segment sum of an
apply and of the build is sorted and goes through
``ops.segsum.sorted_segment_sum``, routed by the device of its tensors: on
the card the hand-written CUDA kernel (every dtype, reading the stored
boundaries), on the host its plain twin.  The kernel's fixed summation order
gives the exact f64 operator the same bits on every run, which
``index_add_``'s atomics on the card would not.  The segment-sum bands
(``with_pallas``, ``edge_f32(pallas=True)``, ``two_float(pallas=True)``) are
the reference kernel's bounds (``max_band``), carried for parity with the
reference; neither route reads them.

Every apply reaches its arrays through three seams: ``_cam`` (per-camera
products, on the camera leaves), ``_esum`` (edge rows and their sorted
segment sums, by landmark or by frame) and ``_vt`` (the ``VT_inv`` GEMM).
Here each runs on the whole operator; the camera-sharded operator of
``parallel/sharded.py`` runs the same stage code slot by slot through its
own seams.

The float32 product of a whole ``SchurQ`` on a CUDA card
(:func:`fused_route`: the f32 phase's and the inner tCG's operator,
``cast_qop(SchurQ, float32)``) takes no seam for its edge sums:
:func:`schurq_product` runs them as four hand-written kernels
(``xmtpu_torch/csrc/schurq.cu``), each a gather and a segment sum by
landmark or by frame with its edge rows made where they are summed, between
the seams' two per-camera einsums and their ``VT_inv`` GEMM: eight launches
where the seams make 36, on an H100 at BAL Ladybug-1723.  The kernels round
each product and sum as the seams do and add each segment's rows in row
order, as ``sorted_segment_sum`` does, so the product has the seams' bits.
Every other product (the exact f64 ``SchurQ``, ``SchurQEdgeF32``,
``SchurQTF``, the sharded operators, every CPU run) goes through the seams;
:func:`schurq_product_plain`, the kernels' plain twin, is the seams'
arithmetic written in the kernels' five stages.

Every product of an operator of this module (``apply``) runs in the span
``xm.schurq.apply`` (the operators' ``apply_span``) and is counted by its
arithmetic in ``utils.timer.applies_f64`` (the exact ``SchurQ``),
``applies_tf`` (``SchurQTF``) or ``applies_f32`` (``SchurQEdgeF32``, and
``SchurQ`` cast to float32); a sharded operator counts as the class it
shards.  A fused product is counted in ``applies_fused`` too, and in
``schurq_product.launches``.  A whole ``SchurQ`` on the fused route is
``capturable``: ``solver/graph_step.py`` replays its products inside CUDA
graphs and counts them as its captures recorded them.  ``SchurQ.build``
runs in the span ``xm.schurq.build``.

``vt_build="auto"`` takes "chol" on both devices (the reference's CPU
branch; f64 Cholesky is native on the H100); "ns" (f32 Cholesky seed + f64
Newton-Schulz) stays selectable.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from xmtpu_torch._device import resolve_device
from xmtpu_torch.ops.fused_tcg import _check, _on_cpu, _raise_on
from xmtpu_torch.ops.qop import QOperator, split_f32, tf_gemm
from xmtpu_torch.ops.segsum import (max_band, planned_offsets,
                                    sorted_segment_sum)
from xmtpu_torch.utils.timer import (applies_f32, applies_f64, applies_fused,
                                     applies_tf, launcher, span, spanned)

APPLY_SPAN = "xm.schurq.apply"
BUILD_SPAN = "xm.schurq.build"

# above this (N * M * 8 bytes) the build switches from one (N, M) V3F slab
# to landmark-chunked Gram accumulation (the reference's ~4 GB budget)
_SLAB_BUDGET_BYTES = 4 << 30

# beyond-slab builds use host pair expansion while sum_l c_l^2 stays under
# this
_PAIR_BUDGET = 30_000_000

# columns of Y one launch of the fused kernels takes (csrc/schurq.cu MAX_OC);
# wider products launch each kernel once per chunk of columns
FUSED_COLUMNS = 8


def _seg(vals, ids, bounds, num):
    """Sorted segment sum of ``vals (E, ...)`` by ``ids`` with CSR
    boundaries ``bounds`` through ``segsum.sorted_segment_sum`` (the CUDA
    kernel on the card, the plain twin on the host)."""
    out = sorted_segment_sum(vals.reshape(vals.shape[0], -1).contiguous(),
                             ids, num, offsets=bounds)
    return out.reshape((num,) + tuple(vals.shape[1:]))


def _sorted_scatter_sum(vals, ids, size: int):
    """Flat ``(size,)`` sums of ``vals (E,)`` by non-decreasing ``ids``:
    each run of equal ids is one segment of :func:`_seg`, its sum written
    once."""
    uniq, counts = torch.unique_consecutive(ids, return_counts=True)
    bounds = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    run = torch.repeat_interleave(
        torch.arange(len(uniq), device=ids.device), counts)
    out = vals.new_zeros(size)
    out[uniq] = _seg(vals, run, bounds.to(torch.int32), len(uniq))
    return out


# ---- the stage arithmetic on one piece ``q`` of an operator (the whole
# operator, or one slot of a sharded one): per-camera products, and the rows
# of each edge before their segment sum.  ``q`` gives the fields by name.

def _q1_apply(q, Yb):
    return torch.einsum("nab,nbo->nao", q.Q1, Yb)


def _v1_dot(q, Yb):
    return torch.einsum("na,nao->no", q.V1, Yb)


def _v1_outer(q, z_t):
    return torch.einsum("na,no->nao", q.V1, z_t)


def _wx_dot_rows(q, Yf):
    """``sum_a wx_l[:, a] * Y[f_l, a-th column block]`` (l-sorted)."""
    o = Yf.shape[1] // 3
    g = Yf[q.f_l]
    t = None
    for a in range(3):
        ta = q.wx_l[:, a:a + 1] * g[:, a * o:(a + 1) * o]
        t = ta if t is None else t + ta
    return t


def _wx_outer_rows(q, z_B):
    """``wx_f[:, a] * z_B[l_f]`` as column blocks (f-sorted)."""
    zg = z_B[q.l_f]
    return torch.cat([q.wx_f[:, a:a + 1] * zg for a in range(3)], dim=1)


def _cf_f_rows(q, z_B):
    return q.cf_f[:, None] * z_B[q.l_f]


def _cf_l_rows(q, x_pad):
    return q.cf_l[:, None] * x_pad[q.f_l]


def _applies(q):
    """The counter of ``q``'s products (module doc)."""
    kind = getattr(q, "kind", type(q))
    if kind is SchurQTF:
        return applies_tf
    if kind is SchurQEdgeF32 or q.inv_q3.dtype != torch.float64:
        return applies_f32
    return applies_f64


def _traced(apply):
    """``apply`` in its operator's span ``apply_span`` (``xm.schurq.apply``),
    counted (module doc)."""
    @functools.wraps(apply)
    def traced(self, Y):
        _applies(self).n += 1
        with span(self.apply_span):
            return apply(self, Y)
    return traced


def _bands(l_l, f_f):
    return (int(max_band(l_l.cpu().numpy())), int(max_band(f_f.cpu().numpy())))


@dataclass
class SchurQ(QOperator):
    """Factored SBA cost operator (fields as in ``xmtpu.ops.schurq.SchurQ``).

    n cameras, m landmarks, e observations; ids 0-based int64:
      Q1 (n, 3, 3), V1 (n, 3); f_l, l_l, wx_l (e, 3), cf_l landmark-sorted;
      f_f, l_f, wx_f, cf_f frame-sorted; bounds_l (m+1,), bounds_f (n+1,)
      int32 CSR boundaries of the two orderings; inv_q3, inv_sqrt_q3 (m,);
      VT_inv (>= n-1, n-1), rows past n-1 zero-padded.
    ``psd_ok``: the structural-PSD claim (cleared by sub-f64 casts and by an
    ``"ns"`` build whose residual failed its guard).  ``band_l``/``band_f``:
    the reference kernel's segment-sum bands per ordering, 0 until
    :meth:`with_pallas` records them (see module doc).
    """

    Q1: torch.Tensor
    V1: torch.Tensor
    f_l: torch.Tensor
    l_l: torch.Tensor
    wx_l: torch.Tensor
    cf_l: torch.Tensor
    f_f: torch.Tensor
    l_f: torch.Tensor
    wx_f: torch.Tensor
    cf_f: torch.Tensor
    bounds_l: torch.Tensor
    bounds_f: torch.Tensor
    inv_q3: torch.Tensor
    inv_sqrt_q3: torch.Tensor
    VT_inv: torch.Tensor
    psd_ok: bool = True
    band_l: int = 0
    band_f: int = 0

    apply_span = APPLY_SPAN

    def with_pallas(self, interpret: "bool | None" = None) -> "SchurQ":
        """The operator with the reference kernel's segment-sum bands
        recorded.  The applies' segment sums already take the CUDA kernel on
        the card and its plain twin on the host; the name and ``interpret``
        (ignored) are the reference's, so callers port unchanged."""
        band_l, band_f = _bands(self.l_l, self.f_f)
        return dataclasses.replace(self, band_l=band_l, band_f=band_f)

    @staticmethod
    @spanned(BUILD_SPAN)
    def build(weights, edges, landmarks, landmark_chunk: "int | None" = None,
              vt_build: str = "auto", device=None) -> "SchurQ":
        """From the same inputs as ``create_matrix`` (1-based edges), on
        ``device`` (None = the CUDA card; ``"cpu"`` for the host).

        ``landmark_chunk``: None = the (N, M) slab while it fits
        ``_SLAB_BUDGET_BYTES``, Gram accumulation beyond (host pair
        expansion for sparse graphs, landmark chunks of this width else);
        0 forces the slab.  ``vt_build``: "chol" (f64 Cholesky), "ns" (f32
        Cholesky seed + f64 Newton-Schulz, rebuilt through "chol" when it
        stalls) or "auto" ("chol" here).
        """
        dev = resolve_device(device)
        edges = np.asarray(edges)
        w = np.asarray(weights, np.float64).ravel()
        x = np.asarray(landmarks, np.float64)
        f = edges[:, 0].astype(np.int64) - 1
        l = edges[:, 1].astype(np.int64) - 1
        N = int(f.max()) + 1
        M = int(l.max()) + 1
        ord_l = np.lexsort((f, l))
        ord_f = np.lexsort((l, f))
        bounds_l = np.searchsorted(l[ord_l], np.arange(M + 1)).astype(np.int32)
        bounds_f = np.searchsorted(f[ord_f], np.arange(N + 1)).astype(np.int32)

        if landmark_chunk is None and N * M * 8 > _SLAB_BUDGET_BYTES:
            landmark_chunk = max(1024, _SLAB_BUDGET_BYTES // (8 * N))
        vt_gram = None
        if landmark_chunk and landmark_chunk < M:
            counts = np.diff(bounds_l).astype(np.int64)
            n_pairs = int(np.sum(counts * counts))
            if n_pairs <= _PAIR_BUDGET:
                vt_gram = torch.as_tensor(
                    _vt_gram_pairs(w, f, l, ord_l, bounds_l, N, M), device=dev)
            else:
                vt_gram = _vt_gram_chunked(w, f, l, ord_l, bounds_l, N, M,
                                           int(landmark_chunk), dev)
        if vt_build == "auto":
            vt_build = "chol"

        def t(a, dtype=None):
            return torch.as_tensor(a, dtype=dtype, device=dev)

        i64 = torch.int64
        args = (t(w), t(x), t(f[ord_l], i64), t(l[ord_l], i64), t(ord_l, i64),
                t(f[ord_f], i64), t(l[ord_f], i64), t(ord_f, i64),
                planned_offsets(bounds_l, dev, "SchurQ landmark"),
                planned_offsets(bounds_f, dev, "SchurQ frame"))
        q, resid_ratio = _build_schurq(*args, N, M, vt_gram=vt_gram,
                                       vt_build=vt_build)
        if vt_build == "ns" and resid_ratio > 2e3:
            # Newton-Schulz stalled (cond(VT) beyond the f32 seed's reach):
            # rebuild through the exact f64 factorization
            q, resid_ratio = _build_schurq(*args, N, M, vt_gram=vt_gram,
                                           vt_build="chol")
        # build-time observability (a host attribute, not a field)
        q.vt_resid_ratio = float(resid_ratio)
        return q

    @property
    def n_cameras(self) -> int:
        return self.Q1.shape[0]

    @property
    def n_landmarks(self) -> int:
        return self.inv_q3.shape[0]

    @property
    def dim(self) -> int:
        return 3 * self.n_cameras

    # ---- the seams (module doc) ----

    def _cam(self, fn, *xs):
        """``fn(self, *xs)`` on the camera leaves; ``xs`` are camera-major."""
        return fn(self, *xs)

    def _esum(self, order: str, fn, *xs):
        """Sorted segment sums of the edge rows ``fn(self, *xs)`` by
        landmark (``order="l"``) or by frame (``"f"``)."""
        if order == "l":
            return _seg(fn(self, *xs), self.l_l, self.bounds_l,
                        self.n_landmarks)
        return _seg(fn(self, *xs), self.f_f, self.bounds_f, self.n_cameras)

    def _vt(self, rhs):
        """``VT_inv @ rhs`` (padded rows included)."""
        return self.VT_inv @ rhs

    # ---- structured pieces ----

    def _vtpT(self, Yb):
        """``Vtp_bar^T Y``: (n,3,o) -> (b_A (n-1,o), b_B (m,o))."""
        n, _, o = Yb.shape
        b_A = self._cam(_v1_dot, Yb)[1:]
        b_B = -self._esum("l", _wx_dot_rows, Yb.reshape(n, 3 * o))
        return b_A, b_B

    def _vtp(self, z_A, z_B):
        """``Vtp_bar [z_A; z_B]`` -> (n, 3, o)."""
        n = self.n_cameras
        o = z_B.shape[-1]
        z_t = torch.cat([torch.zeros_like(z_A[:1]), z_A], dim=0)
        out = self._cam(_v1_outer, z_t)
        red = self._esum("f", _wx_outer_rows, z_B)
        return out - red.reshape(n, 3, o)

    def _v3f(self, z_B):
        """``V3F z_B``: (m, o) -> (n-1, o)."""
        return self._esum("f", _cf_f_rows, z_B)[1:]

    def _v3fT(self, x_A):
        """``V3F^T x_A``: (n-1, o) -> (m, o)."""
        x_pad = torch.cat([torch.zeros_like(x_A[:1]), x_A], dim=0)
        return self._esum("l", _cf_l_rows, x_pad)

    def solve_M(self, b_A, b_B):
        """Exact solve of ``Mbar [x_A; x_B] = [b_A; b_B]`` (padded
        ``VT_inv`` rows are sliced off)."""
        t = self.inv_sqrt_q3[:, None] * b_B
        rhs = b_A + self._v3f(t)
        x_A = self._vt(rhs)[: b_A.shape[0]]
        x_B = (self.inv_q3[:, None] * b_B
               + self.inv_sqrt_q3[:, None] * self._v3fT(x_A))
        return x_A, x_B

    # ---- operator interface ----

    def capturable(self, device) -> bool:
        """Where its products take :func:`schurq_product` on ``device``."""
        q3 = self.inv_q3
        return (fused_route(type(self), q3.dtype, q3.device)
                and q3.device == device)

    @_traced
    def apply(self, Y: torch.Tensor) -> torch.Tensor:
        if fused_route(type(self), self.inv_q3.dtype, self.inv_q3.device):
            return schurq_product(self, Y)
        n = self.n_cameras
        Yb = Y.reshape(n, 3, Y.shape[-1])
        out = self._cam(_q1_apply, Yb)
        b_A, b_B = self._vtpT(Yb)
        z_A, z_B = self.solve_M(b_A, b_B)
        out = out - self._vtp(z_A, z_B)
        return out.reshape(3 * n, Y.shape[-1])

    def diag_blocks(self):
        """``Q1``: a PSD upper bound of the true diagonal blocks (the
        Schur correction is PSD), for the block-Jacobi preconditioner."""
        return self.Q1

    @property
    def psd_by_construction(self) -> bool:
        """Partial minimization of a PSD quadratic is PSD; ``psd_ok`` gates
        the claim (see the reference)."""
        return self.psd_ok

    def recover_y(self, sR: torch.Tensor) -> torch.Tensor:
        """Optimal translations/landmarks ``[t_1..t_{N-1}; p_0..p_{M-1}]``
        (N+M-1, o) for a solved factor."""
        n = self.n_cameras
        Yb = sR.reshape(n, 3, sR.shape[-1])
        b_A, b_B = self._vtpT(Yb)
        z_A, z_B = self.solve_M(b_A, b_B)
        return torch.cat([-z_A, -z_B], dim=0)

    def two_float(self, pallas: "bool | None" = None) -> "SchurQTF":
        """The fully two-float operator (f32-pair edge reductions and
        ``VT_inv`` GEMM); ``pallas`` as in :meth:`edge_f32`."""
        e = self.edge_f32(pallas=pallas)
        vth, vtl = split_f32(self.VT_inv)
        q1h, q1l = split_f32(self.Q1)
        v1h, v1l = split_f32(self.V1)
        return SchurQTF(e.Q1, e.V1, e.f_l, e.l_l, e.f_f, e.l_f,
                        e.wxh_l, e.wxl_l, e.cfh_l, e.cfl_l,
                        e.wxh_f, e.wxl_f, e.cfh_f, e.cfl_f,
                        e.bounds_l, e.bounds_f,
                        e.inv_q3, e.inv_sqrt_q3, vth, vtl,
                        q1h, q1l, v1h, v1l,
                        band_l=e.band_l, band_f=e.band_f)

    def edge_f32(self, pallas: "bool | None" = None) -> "SchurQEdgeF32":
        """The mixed-precision operator (two-float f32 edge reductions
        inside an f64 apply).  ``pallas=True`` records the reference
        kernel's bands on the result, as :meth:`with_pallas` does; the
        segment sums take the CUDA kernel on the card and the plain twin on
        the host whatever it is."""
        q = _make_edge_f32(self)
        if pallas:
            band_l, band_f = _bands(self.l_l, self.f_f)
            q = dataclasses.replace(q, band_l=band_l, band_f=band_f)
        return q


# ---- the fused float32 product (module doc) ----

def fused_route(kind, dtype, device) -> bool:
    """Whether a product of an operator of class ``kind`` whose payload is
    ``dtype`` on ``device`` takes :func:`schurq_product`: a whole
    ``SchurQ`` in float32 on a CUDA card.  ``SchurQEdgeF32`` and
    ``SchurQTF`` (their own two-float arithmetic), the sharded operators of
    ``parallel/``, float64 and every CPU run take the seams."""
    return (kind is SchurQ and dtype == torch.float32
            and device.type == "cuda")


def schurq_product_plain(q: SchurQ, Y: torch.Tensor) -> torch.Tensor:
    """Plain twin of :func:`schurq_product`: ``q.apply(Y)`` in the kernels'
    five stages with the seams' arithmetic, its segment sums through
    :func:`_seg` as theirs, so it has the seams' bits on either device."""
    n, m, o = q.n_cameras, q.n_landmarks, Y.shape[-1]
    Yb = Y.reshape(n, 3, o)
    # 1. by landmark: b_B and t
    b_B = -_seg(_wx_dot_rows(q, Yb.reshape(n, 3 * o)), q.l_l, q.bounds_l, m)
    t = q.inv_sqrt_q3[:, None] * b_B
    # 2. by frame: the right-hand side of cameras 1..n-1
    rhs = (_v1_dot(q, Yb)[1:]
           + _seg(_cf_f_rows(q, t), q.f_f, q.bounds_f, n)[1:])
    # 3. the GEMM
    x_A = (q.VT_inv @ rhs)[: n - 1]
    # 4. by landmark: x_B, through x_pad = [0; x_A]
    x_pad = torch.cat([torch.zeros_like(x_A[:1]), x_A], dim=0)
    x_B = (q.inv_q3[:, None] * b_B + q.inv_sqrt_q3[:, None]
           * _seg(_cf_l_rows(q, x_pad), q.l_l, q.bounds_l, m))
    # 5. by frame: the product
    red = _seg(_wx_outer_rows(q, x_B), q.f_f, q.bounds_f, n)
    out = _q1_apply(q, Yb) - (_v1_outer(q, x_pad) - red.reshape(n, 3, o))
    return out.reshape(3 * n, o)


_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    from xmtpu_torch import _build

    lib = _build.load("schurq")
    if not getattr(lib, "_xm_typed", False):
        lib.xm_schurq_forward.argtypes = [_P] * 13 + [_I] * 5 + [_P]
        lib.xm_schurq_forward.restype = _I
        lib.xm_schurq_finish.argtypes = [_P] * 15 + [_I] * 5 + [_P]
        lib.xm_schurq_finish.restype = _I
        lib._xm_typed = True
    return lib


class _Fused(NamedTuple):
    """An operator's tensors as :func:`schurq_product`'s kernels read them,
    checked once: ``fields`` the operator's tensors they were checked on
    (the cache holds while those are the same objects), and the pointers by
    name (``longs``: the landmark ordering's long segments, from its host
    plan, where it has any)."""

    fields: tuple
    n: int
    m: int
    dev: torch.device
    ptr: dict
    n_long: int
    long_rows: int


_FIELDS = ("V1", "f_l", "wx_l", "cf_l", "l_f", "wx_f", "cf_f", "bounds_l",
           "bounds_f", "inv_q3", "inv_sqrt_q3", "VT_inv")


def _fused_args(q: SchurQ) -> _Fused:
    fields = tuple(getattr(q, k) for k in _FIELDS)
    got = q.__dict__.get("_fused")
    if got is not None and all(a is b for a, b in zip(got.fields, fields)):
        return got
    n, m, E = q.n_cameras, q.n_landmarks, q.f_l.shape[0]
    dev = q.inv_q3.device
    f32, i64, i32 = torch.float32, torch.int64, torch.int32
    shapes = {"V1": ((n, 3), f32),
              "f_l": ((E,), i64), "wx_l": ((E, 3), f32), "cf_l": ((E,), f32),
              "l_f": ((E,), i64), "wx_f": ((E, 3), f32), "cf_f": ((E,), f32),
              "bounds_l": ((m + 1,), i32), "bounds_f": ((n + 1,), i32),
              "inv_q3": ((m,), f32), "inv_sqrt_q3": ((m,), f32)}
    ptr = {k: _check(f"schurq_product: {k}", getattr(q, k), sh, dev, dt)
           for k, (sh, dt) in shapes.items()}
    plan = getattr(q.bounds_l, "csr_plan", None)
    n_long, long_rows = 0, np.iinfo(np.int32).max
    if plan is not None and plan.n_long:
        if (plan.rows, plan.segments) != (E, m):
            raise ValueError(f"schurq_product: the landmark plan is for "
                             f"{plan.rows} rows in {plan.segments} segments, "
                             f"got {E} in {m}")
        n_long, long_rows = plan.n_long, plan.long_rows
        ptr["longs"] = _check("schurq_product: plan", plan.longs,
                              (n_long, 3), dev, i32)
    vt = q.VT_inv
    if (vt.dim() != 2 or vt.shape[0] < n - 1 or vt.shape[1] != n - 1
            or vt.dtype != f32 or vt.device != dev):
        raise ValueError(f"schurq_product: VT_inv {tuple(vt.shape)} "
                         f"{vt.dtype} on {vt.device}")
    got = _Fused(fields, n, m, dev, ptr, n_long, long_rows)
    q._fused = got
    return got


@launcher
def schurq_product(q: SchurQ, Y: torch.Tensor) -> torch.Tensor:
    """``q.apply(Y)`` of a whole float32 ``SchurQ`` (module doc), with the
    seams' bits: on the card the seams' two per-camera einsums, the four
    kernels of ``csrc/schurq.cu`` (``FUSED_COLUMNS`` columns a launch) and
    the seams' ``VT_inv`` GEMM, counted in ``launches`` (one a product) and
    in ``utils.timer.applies_fused``; on the host
    :func:`schurq_product_plain`.  The operator's tensors are checked once
    (cached on it); a CUDA operator that does not fit raises."""
    if _on_cpu(q.inv_q3, Y):
        return schurq_product_plain(q, Y)
    a = _fused_args(q)
    n, m, o = a.n, a.m, Y.shape[-1]
    if Y.numel() != 3 * n * o:
        raise ValueError(f"schurq_product: Y {tuple(Y.shape)}, expected "
                         f"({3 * n}, o)")
    Yb = Y.reshape(n, 3, o)
    out = torch.empty((3 * n, o), dtype=torch.float32, device=a.dev)
    if o == 0:
        return out
    Yc = Yb.reshape(3 * n, o).contiguous()
    _check("schurq_product: Y", Yc, (3 * n, o), a.dev)
    q1y = _q1_apply(q, Yb).contiguous()
    bA = _v1_dot(q, Yb).contiguous()
    # b_B | t | x_B (m x o each); rhs on its own, as the seams allocate it
    scratch = torch.empty(3 * m * o, dtype=torch.float32, device=a.dev)
    rhs = torch.empty((n - 1, o), dtype=torch.float32, device=a.dev)
    b_B = scratch.data_ptr()
    t, x_B = b_B + 4 * m * o, b_B + 8 * m * o
    p, lib = a.ptr, _lib()
    ints = (n, m, o, a.n_long, a.long_rows)
    with torch.cuda.device(a.dev):     # ctypes launches on the current device
        stream = torch.cuda.current_stream(a.dev).cuda_stream
        _raise_on(lib.xm_schurq_forward(
            Yc.data_ptr(), bA.data_ptr(), p["f_l"], p["wx_l"], p["bounds_l"],
            p.get("longs"), p["l_f"], p["cf_f"], p["bounds_f"],
            p["inv_sqrt_q3"], b_B, t, rhs.data_ptr(), *ints, stream),
            "schurq_product")
        x_A = (q.VT_inv @ rhs)[: n - 1]
        _raise_on(lib.xm_schurq_finish(
            q1y.data_ptr(), p["V1"], x_A.data_ptr(), p["f_l"], p["cf_l"],
            p["bounds_l"], p.get("longs"), p["l_f"], p["wx_f"],
            p["bounds_f"], p["inv_q3"], p["inv_sqrt_q3"], b_B, x_B,
            out.data_ptr(), *ints, stream), "schurq_product")
    schurq_product.launches += 1
    applies_fused.n += 1
    return out


def pad_cameras(Q, n_pad: int):
    """Zero-extend the camera axis of a :class:`SchurQ` (or
    :class:`SchurQEdgeF32`) with ``n_pad - n`` phantom cameras that carry
    zero ``Q1``/``V1`` blocks and no observations (see the reference)."""
    n = Q.n_cameras
    if n_pad == n:
        return Q
    assert n_pad > n
    pad = n_pad - n
    upd = {
        "Q1": torch.nn.functional.pad(Q.Q1, (0, 0, 0, 0, 0, pad)),
        "V1": torch.nn.functional.pad(Q.V1, (0, 0, 0, pad)),
    }
    vt = Q.VT_inv
    rows = max(vt.shape[0], n_pad - 1)
    vt_new = torch.zeros((rows, n_pad - 1), dtype=vt.dtype, device=vt.device)
    vt_new[: vt.shape[0], : vt.shape[1]] = vt
    upd["VT_inv"] = vt_new
    # phantom frame segments are empty: repeat the last boundary
    last = Q.bounds_f[-1:]
    upd["bounds_f"] = torch.cat([Q.bounds_f, last.expand(pad)])
    return dataclasses.replace(Q, **upd)


def _wx_dot3(wh, wl, gh, gl, o):
    """Two-float ``sum_a w[:, a] * g[:, a*o:(a+1)*o]``: ``(th, tl)`` f32
    with ``th + tl ~= sum``."""
    th = tl = None
    for a in range(3):
        wah, wal = wh[:, a:a + 1], wl[:, a:a + 1]
        gah, gal = gh[:, a * o:(a + 1) * o], gl[:, a * o:(a + 1) * o]
        t = wah * gah
        c = wah * gal + wal * gah
        th = t if th is None else th + t
        tl = c if tl is None else tl + c
    return th, tl


def _wx_outer3(wh, wl, zh, zl):
    """Two-float outer products ``w[:, a] * z`` as column blocks ``(E, 3o)``
    (a-major)."""
    th = torch.cat([wh[:, a:a + 1] * zh for a in range(3)], dim=1)
    tl = torch.cat([wh[:, a:a + 1] * zl + wl[:, a:a + 1] * zh
                    for a in range(3)], dim=1)
    return th, tl


def _wx_dot_rows2(q, Yh, Yl):
    """Two-float :func:`_wx_dot_rows`: ``(th, tl)``."""
    o = Yh.shape[1] // 3
    return _wx_dot3(q.wxh_l, q.wxl_l, Yh[q.f_l], Yl[q.f_l], o)


def _wx_outer_rows2(q, zh, zl):
    """Two-float :func:`_wx_outer_rows`: ``(th, tl)``."""
    return _wx_outer3(q.wxh_f, q.wxl_f, zh[q.l_f], zl[q.l_f])


def _cf_f_rows2(q, zh, zl):
    gh, gl = zh[q.l_f], zl[q.l_f]
    return (q.cfh_f[:, None] * gh,
            q.cfh_f[:, None] * gl + q.cfl_f[:, None] * gh)


def _cf_l_rows2(q, xh, xl):
    gh, gl = xh[q.f_l], xl[q.f_l]
    return (q.cfh_l[:, None] * gh,
            q.cfh_l[:, None] * gl + q.cfl_l[:, None] * gh)


def _hi_lo_rows(fn):
    """Edge rows ``fn -> (hi, lo)`` as one ``(E, 2D)`` block hi|lo."""
    def rows(q, *xs):
        hi, lo = fn(q, *xs)
        E = hi.shape[0]
        return torch.cat([hi.reshape(E, -1), lo.reshape(E, -1)], dim=1)
    return rows


@dataclass
class SchurQEdgeF32(QOperator):
    """SchurQ with the edge reductions in two-float f32 (hi/lo pairs, the
    two f32 segment sums combined in f64); see the reference.  Both sums of
    a reduction run as ONE ``sorted_segment_sum`` over the hi|lo columns.
    ``bounds_l``/``bounds_f`` are the CSR boundaries the CUDA kernel reads;
    the bands are recorded only (module doc)."""

    Q1: torch.Tensor
    V1: torch.Tensor
    f_l: torch.Tensor
    l_l: torch.Tensor
    f_f: torch.Tensor
    l_f: torch.Tensor
    wxh_l: torch.Tensor
    wxl_l: torch.Tensor
    cfh_l: torch.Tensor
    cfl_l: torch.Tensor
    wxh_f: torch.Tensor
    wxl_f: torch.Tensor
    cfh_f: torch.Tensor
    cfl_f: torch.Tensor
    bounds_l: torch.Tensor
    bounds_f: torch.Tensor
    inv_q3: torch.Tensor
    inv_sqrt_q3: torch.Tensor
    VT_inv: torch.Tensor
    band_l: int = 0
    band_f: int = 0

    @property
    def n_cameras(self) -> int:
        return self.Q1.shape[0]

    @property
    def n_landmarks(self) -> int:
        return self.inv_q3.shape[0]

    @property
    def dim(self) -> int:
        return 3 * self.n_cameras

    def diag_blocks(self):
        return self.Q1

    _cam = SchurQ._cam
    _esum = SchurQ._esum
    _vt = SchurQ._vt

    def _esum2(self, order: str, fn, *xs):
        """Two f32 segment sums of the edge rows ``fn -> (hi, lo)``
        combined in the working dtype, as one sorted segment sum over the
        concatenated hi|lo columns."""
        s2 = self._esum(order, _hi_lo_rows(fn), *xs)
        d = s2.shape[1] // 2
        dt = self.inv_q3.dtype
        return s2[:, :d].to(dt) + s2[:, d:].to(dt)

    def _vtpT(self, Yb):
        n, _, o = Yb.shape
        b_A = self._cam(_v1_dot, Yb)[1:]
        Yh, Yl = split_f32(Yb.reshape(n, 3 * o))
        b_B = -self._esum2("l", _wx_dot_rows2, Yh, Yl)
        return b_A, b_B

    def _vtp(self, z_A, z_B):
        n = self.n_cameras
        o = z_B.shape[-1]
        z_t = torch.cat([torch.zeros_like(z_A[:1]), z_A], dim=0)
        out = self._cam(_v1_outer, z_t)
        zh, zl = split_f32(z_B)
        red = self._esum2("f", _wx_outer_rows2, zh, zl)
        return out - red.reshape(n, 3, o)

    def _v3f(self, z_B):
        zh, zl = split_f32(z_B)
        return self._esum2("f", _cf_f_rows2, zh, zl)[1:]

    def _v3fT(self, x_A):
        x_pad = torch.cat([torch.zeros_like(x_A[:1]), x_A], dim=0)
        xh, xl = split_f32(x_pad)
        return self._esum2("l", _cf_l_rows2, xh, xl)

    solve_M = SchurQ.solve_M
    apply = SchurQ.apply
    apply_span = SchurQ.apply_span
    recover_y = SchurQ.recover_y


def _v1_dot_tf(q, Yh, Yl, dt):
    """Two-float :func:`_v1_dot` on the hi/lo ``V1`` pair, in ``dt``."""
    bh, bl = _wx_dot3(q.v1h, q.v1l, Yh, Yl, Yh.shape[1] // 3)
    return bh.to(dt) + bl.to(dt)


def _v1_outer_tf(q, zth, ztl, dt):
    """Two-float :func:`_v1_outer` as ``(n, 3o)`` column blocks, in ``dt``."""
    oh, ol = _wx_outer3(q.v1h, q.v1l, zth, ztl)
    return oh.to(dt) + ol.to(dt)


def _q1_apply_tf(q, Yh, Yl, dt):
    """Two-float :func:`_q1_apply` on the hi/lo ``Q1`` pair, in ``dt``."""
    o = Yh.shape[1] // 3
    outs_h, outs_l = [], []
    for a in range(3):
        th, tl = _wx_dot3(q.q1h[:, a, :], q.q1l[:, a, :], Yh, Yl, o)
        outs_h.append(th)
        outs_l.append(tl)
    return torch.stack(outs_h, 1).to(dt) + torch.stack(outs_l, 1).to(dt)


@dataclass
class SchurQTF(QOperator):
    """Fully two-float operator: :class:`SchurQEdgeF32` edge reductions
    plus the two-float ``VT_inv`` GEMM (:func:`qop.tf_gemm`) and two-float
    ``Q1``/``V1`` products; ~1e-7 relative apply error against the exact
    operator (see the reference).  Derive with :meth:`SchurQ.two_float`."""

    Q1: torch.Tensor
    V1: torch.Tensor
    f_l: torch.Tensor
    l_l: torch.Tensor
    f_f: torch.Tensor
    l_f: torch.Tensor
    wxh_l: torch.Tensor
    wxl_l: torch.Tensor
    cfh_l: torch.Tensor
    cfl_l: torch.Tensor
    wxh_f: torch.Tensor
    wxl_f: torch.Tensor
    cfh_f: torch.Tensor
    cfl_f: torch.Tensor
    bounds_l: torch.Tensor
    bounds_f: torch.Tensor
    inv_q3: torch.Tensor
    inv_sqrt_q3: torch.Tensor
    vth: torch.Tensor        # f32 hi part of VT_inv
    vtl: torch.Tensor        # f32 lo part of VT_inv
    q1h: torch.Tensor        # f32 hi/lo pair of the per-camera Grams
    q1l: torch.Tensor
    v1h: torch.Tensor        # f32 hi/lo pair of the weighted landmark sums
    v1l: torch.Tensor
    band_l: int = 0
    band_f: int = 0

    apply_span = APPLY_SPAN

    n_cameras = SchurQEdgeF32.n_cameras
    n_landmarks = SchurQEdgeF32.n_landmarks
    dim = SchurQEdgeF32.dim

    def diag_blocks(self):
        return self.Q1

    _cam = SchurQ._cam
    _esum = SchurQ._esum
    _esum2 = SchurQEdgeF32._esum2
    _v3f = SchurQEdgeF32._v3f
    _v3fT = SchurQEdgeF32._v3fT
    solve_M = SchurQ.solve_M

    def _vt(self, rhs):
        """The two-float ``VT_inv @ rhs``."""
        return tf_gemm(self.vth, self.vtl, rhs)

    def _vtpT(self, Yb):
        n, _, o = Yb.shape
        Yh, Yl = split_f32(Yb.reshape(n, 3 * o))
        b_A = self._cam(_v1_dot_tf, Yh, Yl, self.inv_q3.dtype)[1:]
        b_B = -self._esum2("l", _wx_dot_rows2, Yh, Yl)
        return b_A, b_B

    def _vtp(self, z_A, z_B):
        n = self.n_cameras
        o = z_B.shape[-1]
        z_t = torch.cat([torch.zeros_like(z_A[:1]), z_A], dim=0)
        zth, ztl = split_f32(z_t)
        out = self._cam(_v1_outer_tf, zth, ztl, self.inv_q3.dtype)  # (n, 3o)
        zh, zl = split_f32(z_B)
        red = self._esum2("f", _wx_outer_rows2, zh, zl)
        return (out - red.reshape(n, 3 * o)).reshape(n, 3, o)

    @_traced
    def apply(self, Y: torch.Tensor) -> torch.Tensor:
        n = self.n_cameras
        o = Y.shape[-1]
        dt = Y.dtype
        Yh, Yl = split_f32(Y.reshape(n, 3 * o))    # one split feeds all
        out = self._cam(_q1_apply_tf, Yh, Yl, dt)            # (n, 3, o)
        b_A = self._cam(_v1_dot_tf, Yh, Yl, dt)[1:]
        b_B = -self._esum2("l", _wx_dot_rows2, Yh, Yl)
        z_A, z_B = self.solve_M(b_A, b_B)
        out = out - self._vtp(z_A, z_B)
        return out.reshape(3 * n, o)

    recover_y = SchurQ.recover_y


def operator_error_estimate(Q_ref, Q_fast, iters: int = 6, seed: int = 0,
                            o: int = 1) -> float:
    """Spectral-norm estimate of ``Delta = Q_fast - Q_ref`` by power
    iteration on ``Delta^T Delta`` (a host float; converges from below).
    The start vector comes from a CPU ``torch.Generator`` seeded with
    ``seed``, so host and card start alike."""
    dev = Q_ref.Q1.device
    gen = torch.Generator(device="cpu")
    gen.manual_seed(seed)
    v = torch.randn((Q_ref.dim, 1), generator=gen, dtype=torch.float64).to(dev)
    v = v / torch.linalg.norm(v)
    sigma = torch.zeros((), dtype=torch.float64, device=dev)
    for _ in range(iters):
        w = Q_fast.apply(v) - Q_ref.apply(v)
        u = Q_fast.apply(w) - Q_ref.apply(w)
        nrm = torch.linalg.norm(u)
        sigma = torch.sqrt(torch.clamp(nrm, min=1e-300))
        v = u / torch.clamp(nrm, min=1e-300)
    return float(sigma)


def _make_edge_f32(q: SchurQ) -> SchurQEdgeF32:
    wxh_l, wxl_l = split_f32(q.wx_l)
    cfh_l, cfl_l = split_f32(q.cf_l)
    wxh_f, wxl_f = split_f32(q.wx_f)
    cfh_f, cfl_f = split_f32(q.cf_f)
    return SchurQEdgeF32(q.Q1, q.V1, q.f_l, q.l_l, q.f_f, q.l_f,
                         wxh_l, wxl_l, cfh_l, cfl_l,
                         wxh_f, wxl_f, cfh_f, cfl_f,
                         q.bounds_l, q.bounds_f,
                         q.inv_q3, q.inv_sqrt_q3, q.VT_inv)


def _vt_gram_pairs(w, f, l, ord_l, bounds_l, N: int, M: int) -> np.ndarray:
    """Exact ``V3F_full @ V3F_full^T`` (camera-0 row included) by
    per-landmark pair expansion on the host (a copy of the reference's)."""
    q3h = np.bincount(l, weights=w, minlength=M)
    fs, ls, ws = f[ord_l], l[ord_l], w[ord_l]
    cf = ws / np.sqrt(q3h[ls])

    counts = np.diff(bounds_l).astype(np.int64)
    P = counts * counts
    off = np.concatenate([[0], np.cumsum(P)])
    t = np.arange(off[-1], dtype=np.int64) - np.repeat(off[:-1], P)
    c_rep = np.repeat(np.maximum(counts, 1), P)
    s_rep = np.repeat(bounds_l[:-1].astype(np.int64), P)
    a = s_rep + t // c_rep
    b = s_rep + t % c_rep
    flat = fs[a] * np.int64(N) + fs[b]
    gram = np.bincount(flat, weights=cf[a] * cf[b],
                       minlength=N * N).reshape(N, N)
    return gram


def _vt_gram_chunked(w, f, l, ord_l, bounds_l, N: int, M: int, mc: int,
                     device) -> torch.Tensor:
    """Accumulate ``V3F_full @ V3F_full.T`` (camera-0 row included) over
    landmark chunks of width ``mc``: per chunk an (mc, N) slab built by a
    flat sorted sum and one GEMM.  Memory O(N * mc)."""
    q3h = np.bincount(l, weights=w, minlength=M)
    fs, ls, ws = f[ord_l], l[ord_l], w[ord_l]
    cf = (ws / np.sqrt(q3h[ls])) * (fs > 0)

    starts = np.asarray(bounds_l[0:M:mc], np.int64)
    ends = np.asarray(bounds_l[np.minimum(np.arange(0, M, mc) + mc, M)],
                      np.int64)
    gram = torch.zeros((N, N), dtype=torch.float64, device=device)
    for k, (e0, e1) in enumerate(zip(starts, ends)):
        li = torch.as_tensor((ls[e0:e1] - k * mc) * N + fs[e0:e1],
                             device=device)
        co = torch.as_tensor(cf[e0:e1], device=device)
        slab = _sorted_scatter_sum(co, li, mc * N).reshape(mc, N)
        gram = gram + slab.T @ slab
    return gram


def _vt_inv_mixed(VT: torch.Tensor):
    """SPD inverse via an f32 Cholesky seed + f64 Newton-Schulz (see the
    reference).  Returns ``(X, resid_ratio)`` with the host float
    ``resid_ratio = ||I - VT X||_F`` in multiples of the attainable f64
    floor ``eps ||VT|| ||X||``; the caller falls back to the exact
    factorization when it stalls."""
    n = VT.shape[0]
    dt, dev = VT.dtype, VT.device
    scale = torch.max(torch.diagonal(VT)).to(torch.float32)
    VT32 = VT.to(torch.float32)
    eye32 = torch.eye(n, dtype=torch.float32, device=dev)

    # escalate a relative diagonal shift until the f32 factorization holds
    # (torch's Cholesky reports failure in ``info`` where JAX returns NaN)
    shift = np.float32(0.0)
    L, info = torch.linalg.cholesky_ex(VT32)
    while (int(info) != 0 or not bool(torch.isfinite(L).all())) \
            and shift < 1.0:
        shift = max(shift * np.float32(16.0), np.float32(1e-7))
        L, info = torch.linalg.cholesky_ex(VT32 + (shift * scale) * eye32)
    Linv = torch.linalg.solve_triangular(L, eye32, upper=False, left=True)
    X = (Linv.T @ Linv).to(dt)

    eye = torch.eye(n, dtype=dt, device=dev)

    def resid_of(X):
        E = eye - VT @ X
        return E, float(torch.linalg.norm(E))

    E, r = resid_of(X)
    r_prev, it = float("inf"), 0
    # continue while strictly contracting; the f64 floor shows up as a
    # non-decreasing residual and stops the loop
    while it < 14 and r > 1e-14 and r < r_prev:
        X = X + X @ E
        X = 0.5 * (X + X.T)        # re-symmetrize every step
        E, r_new = resid_of(X)
        r_prev, r, it = r, r_new, it + 1
    floor = (np.finfo(np.float64).eps * float(torch.linalg.norm(VT))
             * float(torch.linalg.norm(X)))
    return X, r / max(floor, 1e-300)


def _build_schurq(w, x, f_l, l_l, ord_l, f_f, l_f, ord_f, bounds_l, bounds_f,
                  N: int, M: int, vt_gram=None, vt_build: str = "chol"):
    """The operator's arrays from the sorted edge orderings.  Returns
    ``(SchurQ, resid_ratio)`` (0.0 for "chol")."""
    wx = w[:, None] * x
    q2 = _seg(w[ord_f], f_f, bounds_f, N)
    q3 = _seg(w[ord_l], l_l, bounds_l, M)
    Q1 = _seg((wx[:, :, None] * x[:, None, :])[ord_f], f_f, bounds_f, N)
    V1 = _seg(wx[ord_f], f_f, bounds_f, N)
    inv_q3 = 1.0 / q3
    inv_sqrt_q3 = 1.0 / torch.sqrt(q3)

    cf_l = w[ord_l] * inv_sqrt_q3[l_l] * (f_l > 0)
    cf_f = w[ord_f] * inv_sqrt_q3[l_f] * (f_f > 0)
    if vt_gram is not None:
        gram = vt_gram[1:, 1:]
    else:
        # the (N, M) V3F slab by a flat sorted sum (f-sorted edges make
        # f*M + l monotone)
        flat = _sorted_scatter_sum(cf_f, f_f * M + l_f, N * M)
        V3F = flat.reshape(N, M)[1:]
        gram = V3F @ V3F.T
        del flat, V3F
    VT = torch.diag(q2[1:]) - gram
    resid_ratio = 0.0
    if vt_build == "ns":
        VT_inv, resid_ratio = _vt_inv_mixed(VT)
    else:
        # torch's Cholesky reports failure in ``info``; the reference's
        # returns NaN, which then fills VT_inv
        L, info = torch.linalg.cholesky_ex(VT)
        eye = torch.eye(N - 1, dtype=w.dtype, device=w.device)
        VT_inv = torch.cholesky_solve(eye, L)
        if int(info) != 0:
            VT_inv = torch.full_like(VT_inv, float("nan"))
    q = SchurQ(Q1, V1, f_l, l_l, wx[ord_l], cf_l, f_f, l_f, wx[ord_f], cf_f,
               bounds_l, bounds_f, inv_q3, inv_sqrt_q3, VT_inv)
    return q, resid_ratio
