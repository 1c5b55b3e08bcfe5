"""Abstract Q-matrix operator.

PyTorch counterpart of ``xmtpu/ops/qop.py``.  Every hot operation in the
solver touches Q only through the product ``Q @ Y`` with a thin (3n, o)
right-hand side, so the operator is a small class with ``apply``.  This
slice ports the dense operator; the two-float and implicit (SchurQ)
operators arrive with the implicit slice.
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

    @property
    def psd_by_construction(self) -> bool:
        """True when the operator is structurally PSD (a Schur complement of
        a sum of squares); see ``xmtpu.ops.qop.QOperator``."""
        return False

    def __call__(self, Y: torch.Tensor) -> torch.Tensor:
        return self.apply(Y)


@dataclass
class DenseQ(QOperator):
    """Dense Q — one GEMM per apply (TF32 off: full-precision products).

    ``psd_hint``: set when the matrix is known PSD by construction (a full
    f64 ``create_matrix`` assembly); cleared by any cast below f64.
    """

    C: torch.Tensor
    psd_hint: bool = False

    @property
    def dim(self) -> int:
        return self.C.shape[0]

    @property
    def psd_by_construction(self) -> bool:
        return self.psd_hint

    def apply(self, Y: torch.Tensor) -> torch.Tensor:
        return self.C @ Y

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
    kept, others cast to float64); with ``device``, move it there."""
    if isinstance(Q, DenseQ):
        if device is not None and Q.C.device != torch.device(device):
            return DenseQ(Q.C.to(device), Q.psd_hint)
        return Q
    if isinstance(Q, QOperator):
        return Q
    if isinstance(Q, np.ndarray) and not Q.flags.writeable:
        Q = Q.copy()             # torch.as_tensor wants a writable buffer
    C = torch.as_tensor(Q, device=device)
    if not C.is_floating_point():
        C = C.to(torch.float64)
    return DenseQ(C)


def cast_qop(Q, dtype) -> QOperator:
    """Cast an operator's floating-point payload to ``dtype``.

    Casting below f64 CLEARS any structural-PSD claim: the cast's ~1e-7
    relative rounding exceeds the certificate's acceptance bound.
    """
    Q = as_qop(Q)
    if not isinstance(Q, DenseQ):
        raise NotImplementedError(
            f"cast_qop: {type(Q).__name__} is not ported yet (dense only)")
    Qc = DenseQ(Q.C.to(dtype), Q.psd_hint)
    if dtype != torch.float64 and Qc.psd_hint:
        Qc = dataclasses.replace(Qc, psd_hint=False)
    return Qc
