"""Build and load the package's CUDA kernels (``xmtpu_torch/csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library with
a plain C interface, loaded with ``ctypes``.  Builds happen at first use, all
sources in parallel (one ``nvcc`` each), into ``xmtpu_torch/_build/<hash>/``
keyed by a hash of the sources and flags, so an edited source rebuilds and an
unchanged one loads at once.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("xmtpu_torch: nvcc not found (set CUDA_HOME); the "
                           "CUDA kernels are built from source at first use")
    return path


def sources() -> list[str]:
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def _build_dir() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sources():
        with open(os.path.join(CSRC, name + ".cu"), "rb") as f:
            h.update(name.encode() + f.read())
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16])


def build_all() -> dict:
    """Compile every source that is not built yet, all at once.  Returns
    ``{name: {"seconds": wall, "ptxas": compiler report}}`` for the sources
    built by this call (empty when everything was cached)."""
    out_dir = _build_dir()
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name in sources():
        lib = os.path.join(out_dir, f"lib{name}.so")
        if os.path.exists(lib):
            continue
        # write to a temporary name, then rename: a concurrent loader never
        # sees a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, name + ".cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib)
    report = {}
    for name, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{log}")
        os.replace(tmp, lib)
        report[name] = {"seconds": time.perf_counter() - t0, "ptxas": log}
    return report


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = os.path.join(_build_dir(), f"lib{name}.so")
    if not os.path.exists(lib):
        build_all()
    return ctypes.CDLL(lib)
