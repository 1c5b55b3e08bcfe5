"""Bit-compatible readers/writers for the XM ``.bin`` exchange format.

Format (little-endian), per the reference implementation
(``utils/io.py:17-54`` and ``XM/src/XM_main.cu:18-33``):

* 2-D matrix: ``int32 rows``, ``int32 cols`` header (or ``uint64`` pair when
  ``byte=8``), followed by ``rows*cols`` float64 values in **column-major**
  order.
* 1-D array: ``int32 length`` header followed by ``length`` float64 values.

The reference pipeline uses files as the transport between its Python mid-end
and the CUDA solver (``Q.bin``/``Abar.bin`` written by assembly,
``R.bin``/``s.bin`` written by the solver).  These functions exist for fixture
loading and for drop-in interop with reference datasets.

A copy of ``xmtpu/io/bin_format.py`` (pure numpy): the PyTorch port
keeps its own copy so that it never imports the JAX package.
"""

from __future__ import annotations

import os

import numpy as np


def save_matrix_to_bin(filename: str | os.PathLike, matrix: np.ndarray, byte: int = 4) -> None:
    """Save a 2-D array; header ``rows, cols`` then column-major float64 payload."""
    matrix = np.asarray(matrix)
    if matrix.ndim != 2:
        raise ValueError(f"expected a 2-D matrix, got shape {matrix.shape}")
    rows, cols = matrix.shape
    header_dtype = np.int32 if byte == 4 else np.uint64
    with open(filename, "wb") as f:
        np.array([rows, cols], dtype=header_dtype).tofile(f)
        # .T.tofile writes the C-order walk of the transpose == column-major
        # walk of the original (utils/io.py:29).
        np.ascontiguousarray(matrix.T, dtype=np.float64).tofile(f)


def load_matrix_from_bin(filename: str | os.PathLike, byte: int = 4):
    """Load a 2-D matrix. Returns ``(matrix, rows)`` like the reference loader."""
    with open(filename, "rb") as f:
        header_dtype = np.int32 if byte == 4 else np.uint64
        rows, cols = (int(x) for x in np.fromfile(f, dtype=header_dtype, count=2))
        data = np.fromfile(f, dtype=np.float64, count=rows * cols)
    if data.size != rows * cols:
        raise ValueError(
            f"{filename}: expected {rows * cols} float64 values, found {data.size}"
        )
    return data.reshape((rows, cols), order="F"), rows


def save_array_to_bin(filename: str | os.PathLike, array: np.ndarray) -> None:
    """Save a 1-D array; ``int32 length`` header then float64 payload."""
    array = np.asarray(array).ravel()
    with open(filename, "wb") as f:
        np.array([array.size], dtype=np.int32).tofile(f)
        array.astype(np.float64).tofile(f)


def load_array_from_bin(filename: str | os.PathLike) -> np.ndarray:
    """Load a 1-D array saved by :func:`save_array_to_bin`."""
    with open(filename, "rb") as f:
        length = int(np.fromfile(f, dtype=np.int32, count=1)[0])
        array = np.fromfile(f, dtype=np.float64, count=length)
    if array.size != length:
        raise ValueError(f"{filename}: expected {length} values, found {array.size}")
    return array
