"""Typed solver configuration.

Counterpart of ``xmtpu/config.py`` for the part this package ports: the
staircase + trust-region knobs.  The pipeline configurations (graph, xm2,
depth) arrive with the pipeline modules.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from xmtpu_torch.solver.trust_region import TRConfig


@dataclass(frozen=True)
class SolverConfig:
    """Staircase + trust-region knobs (XM.solve positional args)."""
    max_rank: int = 10
    tol: float = 1e-6
    lam: float = 0.0
    max_time: float = 1000.0
    tr: TRConfig = field(default_factory=TRConfig)
    certificate_method: str = "auto"   # eigh | lanczos | auto
