"""xmtpu_torch — the PyTorch + CUDA port of xmtpu for NVIDIA Hopper.

A second package beside the JAX reference ``xmtpu``: the same module paths
and public names, written as eager PyTorch on tensors, with the reference's
Pallas TPU kernels replaced by hand-written CUDA C++ kernels for ``sm_90a``
(``xmtpu_torch/csrc``), built with ``nvcc`` at first use.

This slice covers the certified dense rank staircase: ``.bin`` I/O, dense
``Q`` assembly, the product manifold, the RTR-tCG trust region with its mixed
f32/f64 ladder (f32 tCG iterations through the fused kernels), the dense
dual certificate and the rank staircase.

Entry points take ``device=None``, meaning the CUDA card; they raise when no
card is present unless the caller passes ``device="cpu"``.  The package
never imports ``jax`` or ``xmtpu``.

The solver works in float64 like the reference.  TF32 is switched off for
matmuls and convolutions: the reference runs every f32 product at
``Precision.HIGHEST`` and measured ~6e-3 relative error without it.
"""

import torch as _torch

_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from xmtpu_torch.io.bin_format import (  # noqa: E402
    load_matrix_from_bin,
    save_matrix_to_bin,
    load_array_from_bin,
    save_array_to_bin,
)
from xmtpu_torch.solver.staircase import (  # noqa: E402
    solve,
    solve_with_init,
    solve_rank3,
    solve_arrays,
    SolveResult,
)
from xmtpu_torch.solver.trust_region import trust_region_solve, TRConfig  # noqa: E402
from xmtpu_torch.solver.certificate import certify, CertificateResult  # noqa: E402
from xmtpu_torch.assembly.creatematrix import (  # noqa: E402
    create_matrix,
    create_matrix_arrays,
)

__version__ = "0.1.0"

__all__ = [
    "__version__",
    "load_matrix_from_bin",
    "save_matrix_to_bin",
    "load_array_from_bin",
    "save_array_to_bin",
    "solve",
    "solve_with_init",
    "solve_rank3",
    "solve_arrays",
    "SolveResult",
    "trust_region_solve",
    "TRConfig",
    "certify",
    "CertificateResult",
    "create_matrix",
    "create_matrix_arrays",
]
