"""Native runtime: the union-find connected components, built on demand.

The port's own copy of ``xmtpu/runtime`` (``connected_component_labels``
only).  ``native.cpp`` is compiled by ``g++`` at first use into
``xmtpu_torch/_build/`` (keyed by a hash of the source) and loaded with
``ctypes``.  Where no compiler is available, the same labels come from
scipy, the reference's fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "native.cpp")
_BUILD = os.path.join(os.path.dirname(_HERE), "_build")


@functools.cache
def _load():
    """The loaded library, or None when it cannot be built."""
    with open(_SRC, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    so = os.path.join(_BUILD, f"native-{tag}.so")
    try:
        if not os.path.exists(so):
            os.makedirs(_BUILD, exist_ok=True)
            # write to a temporary name, then rename: a concurrent loader
            # never sees a half-written library
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
            os.close(fd)
            try:
                subprocess.run(["g++", "-O3", "-shared", "-fPIC",
                                "-std=c++17", _SRC, "-o", tmp],
                               check=True, capture_output=True)
                os.replace(tmp, so)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        lib = ctypes.CDLL(so)
    except (OSError, subprocess.CalledProcessError):
        return None
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.xmtpu_connected_components.restype = ctypes.c_int64
    lib.xmtpu_connected_components.argtypes = [
        i64p, i64p, ctypes.c_int64, ctypes.c_int64, i64p]
    return lib


def have_native() -> bool:
    return _load() is not None


def connected_component_labels(u, v, n_nodes: int):
    """Component label per node for the graph with edges ``(u[i], v[i])``.
    Returns ``(n_components, labels)``: the native union-find when built,
    scipy otherwise."""
    u = np.ascontiguousarray(u, dtype=np.int64)
    v = np.ascontiguousarray(v, dtype=np.int64)
    lib = _load()
    if lib is not None:
        labels = np.empty(n_nodes, dtype=np.int64)
        n_comp = lib.xmtpu_connected_components(u, v, len(u), n_nodes, labels)
        return int(n_comp), labels
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components
    g = coo_matrix((np.ones(len(u)), (u, v)), shape=(n_nodes, n_nodes))
    n_comp, labels = connected_components(g + g.T, directed=False)
    return int(n_comp), labels.astype(np.int64)
