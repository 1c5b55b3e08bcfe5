from xmtpu_torch.assembly.creatematrix import create_matrix, create_matrix_arrays

__all__ = ["create_matrix", "create_matrix_arrays"]
