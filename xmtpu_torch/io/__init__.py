from xmtpu_torch.io.bin_format import (
    load_matrix_from_bin,
    save_matrix_to_bin,
    load_array_from_bin,
    save_array_to_bin,
)

__all__ = [
    "load_matrix_from_bin",
    "save_matrix_to_bin",
    "load_array_from_bin",
    "save_array_to_bin",
]
