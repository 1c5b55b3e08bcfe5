from xmtpu_torch.ops import manifold
from xmtpu_torch.ops.qop import QOperator, DenseQ, q_apply

__all__ = ["manifold", "QOperator", "DenseQ", "q_apply"]
