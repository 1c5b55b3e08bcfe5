"""xmtpu_torch — the PyTorch + CUDA port of xmtpu for NVIDIA Hopper.

A second package beside the JAX reference ``xmtpu``: the same module paths
and public names, written as eager PyTorch on tensors, with the reference's
Pallas TPU kernels replaced by hand-written CUDA C++ kernels for ``sm_90a``
(``xmtpu_torch/csrc``), built with ``nvcc`` at first use.

Ported so far: the certified dense rank staircase (``.bin`` I/O, dense
``Q`` assembly, the product manifold, the RTR-tCG trust region with its
mixed f32/f64 ladder — f32 tCG iterations through the fused kernels — the
dense dual certificate and the rank staircase); the implicit path past
dense memory (the factored ``SchurQ`` operator and its two-float variants,
with every sorted segment sum on the card through a hand-written kernel, the
matvec certificate, view-graph cleanup, recovery and the XM^2 pipeline);
XM-SfM's mapper (``python -m xmtpu_torch`` with its six subcommands, the
COLMAP-database mapper's stages 0-4); its tail stages 5-8 (global
positioning, bundle adjustment, retriangulation and pruning, whose segment
sums run through the same kernel); and the rest of the single-card
pipeline: the relative-pose filter and the LM refinement
(``refine_bundle``, its sums through the same kernel), the image front end
(OpenCV features and two-view geometry, the depth adapters, the tiny
monodepth net on the card, the dataset loaders), the pipeline
configurations, logging, trace and viewer helpers; and the multi-slot
solves of ``xmtpu.parallel`` (``xmtpu_torch.parallel``: dense ``C`` and
``SchurQ`` sharded over the slots of a mesh, one card holding several
slots or one slot a card, and the multi-process dense solve on
``torch.distributed``).

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

from xmtpu_torch.version import __version__  # noqa: E402

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
from xmtpu_torch.pipeline.recover import recover_XM  # noqa: E402
from xmtpu_torch.pipeline.graph import checklandmarks, delete_threshold  # noqa: E402

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
    "recover_XM",
    "checklandmarks",
    "delete_threshold",
]
