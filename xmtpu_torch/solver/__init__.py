from xmtpu_torch.solver.trust_region import trust_region_solve, TRConfig, TRResult
from xmtpu_torch.solver.certificate import certify, CertificateResult
from xmtpu_torch.solver.staircase import solve, solve_with_init, solve_rank3, solve_arrays, SolveResult

__all__ = [
    "trust_region_solve",
    "TRConfig",
    "TRResult",
    "certify",
    "CertificateResult",
    "solve",
    "solve_with_init",
    "solve_rank3",
    "solve_arrays",
    "SolveResult",
]
