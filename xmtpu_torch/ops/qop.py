"""Abstract Q-matrix operator.

PyTorch counterpart of ``xmtpu/ops/qop.py``.  Every hot operation in the
solver touches Q only through the product ``Q @ Y`` with a thin (3n, o)
right-hand side, so the operator is a small class with ``apply``: the
dense ``DenseQ``, its two-float form ``DenseQTF``, the implicit
``SchurQ`` family of ``ops/schurq.py``, and the operators sharded over a
mesh of ``parallel/``.  Each operator casts and moves itself
(:meth:`QOperator.cast`, :meth:`QOperator.to`), so a sharded operator is
cast slab by slab and is never gathered onto one device by a move.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch


class QOperator:
    """Base class: a symmetric (3n, 3n) linear operator."""

    @property
    def dim(self) -> int:  # 3n
        raise NotImplementedError

    def apply(self, Y: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def diag_blocks(self):
        """(n, 3, 3) per-camera diagonal blocks ``C_ii``, or None when the
        operator cannot produce them cheaply.  Used by the trust-region
        solver's block-Jacobi tCG preconditioner."""
        return None

    #: True for a dense matrix, whole or in row slabs: the mixed ladder
    #: takes its f32 stages on the operator's own f32 cast
    dense_rows = False

    #: the span (``utils.timer.span``) that each product opens, or None
    apply_span = None

    def capturable(self, device) -> bool:
        """Whether a product may be captured into a CUDA graph of the f32
        outer step on the card ``device`` (``solver/graph_step.py``): the
        operator is whole and in float32 on that card, and its product
        reads nothing back to the host.  False unless a class says so."""
        return False

    @property
    def psd_by_construction(self) -> bool:
        """True when the operator is structurally PSD (a Schur complement of
        a sum of squares); see ``xmtpu.ops.qop.QOperator``."""
        return False

    def __call__(self, Y: torch.Tensor) -> torch.Tensor:
        return self.apply(Y)

    @property
    def device(self) -> torch.device:
        """The device of an apply's input and output: here, that of the
        operator's first tensor field."""
        for v in vars(self).values():
            if isinstance(v, torch.Tensor):
                return v.device
        raise TypeError(f"{type(self).__name__} holds no tensor")

    def cast(self, dtype) -> "QOperator":
        """The operator with every floating-point tensor field cast to
        ``dtype`` (index tensors and static fields untouched); casting below
        f64 clears any structural-PSD claim (``psd_hint``, ``psd_ok``)."""
        upd = {f.name: v.to(dtype) for f in dataclasses.fields(self)
               if isinstance(v := getattr(self, f.name), torch.Tensor)
               and v.is_floating_point()}
        if dtype != torch.float64:
            for flag in ("psd_hint", "psd_ok"):
                if getattr(self, flag, False):
                    upd[flag] = False
        return dataclasses.replace(self, **upd)

    def to(self, device) -> "QOperator":
        """The operator with every tensor field on ``device`` (the operator
        itself when they all are)."""
        dev = torch.device(device)
        upd = {f.name: v.to(dev) for f in dataclasses.fields(self)
               if isinstance(v := getattr(self, f.name), torch.Tensor)
               and v.device != dev}
        return dataclasses.replace(self, **upd) if upd else self


@dataclass
class DenseQ(QOperator):
    """Dense Q — one GEMM per apply (TF32 off: full-precision products).

    ``psd_hint``: set when the matrix is known PSD by construction (a full
    f64 ``create_matrix`` assembly); cleared by any cast below f64.
    """

    C: torch.Tensor
    psd_hint: bool = False
    dense_rows = True

    @property
    def dim(self) -> int:
        return self.C.shape[0]

    @property
    def psd_by_construction(self) -> bool:
        return self.psd_hint

    def apply(self, Y: torch.Tensor) -> torch.Tensor:
        return self.C @ Y

    def capturable(self, device) -> bool:
        return self.C.dtype == torch.float32 and self.C.device == device

    def diag_blocks(self):
        n = self.dim // 3
        # strided view of the n diagonal 3x3 blocks: (3, 3, n) -> (n, 3, 3)
        return torch.diagonal(self.C.view(n, 3, n, 3), dim1=0,
                              dim2=2).permute(2, 0, 1)


def q_apply(Q, Y: torch.Tensor) -> torch.Tensor:
    """Apply Q to Y.  Q may be a raw (3n, 3n) tensor or a QOperator."""
    if isinstance(Q, QOperator):
        return Q.apply(Y)
    return Q @ Y


def as_qop(Q, device=None) -> QOperator:
    """Wrap a raw matrix (tensor or array) as a ``DenseQ`` (float types
    kept, others cast to float64); with ``device``, move it there (an
    operator through its own :meth:`QOperator.to`: a sharded one stays on
    its mesh and raises for another device)."""
    if isinstance(Q, QOperator):
        return Q if device is None else Q.to(device)
    if isinstance(Q, np.ndarray) and not Q.flags.writeable:
        Q = Q.copy()             # torch.as_tensor wants a writable buffer
    C = torch.as_tensor(Q, device=device)
    if not C.is_floating_point():
        C = C.to(torch.float64)
    return DenseQ(C)


def split_f32(x: torch.Tensor):
    """Two-float split: ``x ~= hi + lo`` with both parts f32.  The lo part
    carries the bits below f32's 24-bit mantissa."""
    hi = x.to(torch.float32)
    return hi, (x - hi.to(x.dtype)).to(torch.float32)


def tf_gemm(ah: torch.Tensor, al: torch.Tensor, y: torch.Tensor):
    """Two-float GEMM ``(ah + al) @ y`` to first order, combined in
    ``y``'s dtype: ``ah @ [y_hi | y_lo]`` as one f32 GEMM, ``al @ y_hi`` as a
    second; the lo*lo term (~1e-15 relative) is dropped, as in the
    reference."""
    yh = y.to(torch.float32)
    yl = (y - yh.to(y.dtype)).to(torch.float32)
    a = ah @ torch.cat([yh, yl], dim=1)
    b = al @ yh
    o = y.shape[1]
    return a[:, :o].to(y.dtype) + a[:, o:].to(y.dtype) + b.to(y.dtype)


@dataclass
class DenseQTF(QOperator):
    """Two-float dense operator: the f64 cost matrix stored as an f32 hi/lo
    pair, applied with :func:`tf_gemm` (~1.5e-7 relative noise floor).
    ``Qdiag``: the exact f64 diagonal blocks, for preconditioning."""

    Ch: torch.Tensor
    Cl: torch.Tensor
    Qdiag: torch.Tensor

    @property
    def dim(self) -> int:
        return self.Ch.shape[0]

    def apply(self, Y: torch.Tensor) -> torch.Tensor:
        return tf_gemm(self.Ch, self.Cl, Y)

    def diag_blocks(self):
        return self.Qdiag


def dense_two_float(C) -> DenseQTF:
    """The two-float dense operator of an f64 matrix / ``DenseQ``."""
    Q = as_qop(C)
    ch, cl = split_f32(Q.C)
    return DenseQTF(ch, cl, Q.diag_blocks().clone())


def cast_qop(Q, dtype) -> QOperator:
    """Cast an operator's floating-point payload to ``dtype`` through its
    own :meth:`QOperator.cast` (a raw matrix is wrapped as ``DenseQ``
    first).

    Casting below f64 CLEARS any structural-PSD claim (``DenseQ.psd_hint``,
    ``SchurQ.psd_ok``): the cast's ~1e-7 relative rounding exceeds the
    certificate's acceptance bound.
    """
    return as_qop(Q).cast(dtype)
