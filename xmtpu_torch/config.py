"""Unified typed configuration.

Counterpart of ``xmtpu/config.py``: the reference's knobs (positional
solver args, the reference scripts' hardcoded thresholds and constants)
collected into frozen dataclasses with the reference's defaults.
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


@dataclass(frozen=True)
class GraphConfig:
    """View-graph cleanup thresholds (checkconnection.py:18,36)."""
    frame_min_obs: int = 10
    landmark_min_frames: int = 1


@dataclass(frozen=True)
class XM2Config:
    """Outlier-rejection loop (3_test_colmap_glomap.py:299-351)."""
    percentile: float = 90.0
    relative_error: bool = False       # 4_test_unidepth.py:321
    scale_mean_sigmas: float = 2.0     # |mean(s)-1| > 2 std -> regularize
    scale_small_value: float = 0.1     # count scales below this...
    scale_small_count: int = 10        # ...more than this -> regularize


@dataclass(frozen=True)
class DepthConfig:
    """Depth lifting (3_test:212-262, 4_test:234-245)."""
    border_margin: int = 0             # 5 for learned depth
    clip_percentile: float | None = None   # 95.0 for learned depth
    weight_power: float = 2.0          # weight = confidence^2


@dataclass(frozen=True)
class PipelineConfig:
    solver: SolverConfig = field(default_factory=SolverConfig)
    graph: GraphConfig = field(default_factory=GraphConfig)
    xm2: XM2Config = field(default_factory=XM2Config)
    depth: DepthConfig = field(default_factory=DepthConfig)

    @staticmethod
    def adaptive_lam(n_edges: int, n_frames: int) -> float:
        """The reference's regularization rule ``lam = |E| / N``
        (3_test:284)."""
        return n_edges / max(1, n_frames)
