from xmtpu_torch.pipeline.graph import checklandmarks, delete_threshold
from xmtpu_torch.pipeline.recover import recover_XM

__all__ = ["checklandmarks", "delete_threshold", "recover_XM"]
