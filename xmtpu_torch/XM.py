"""The reference's three file-based entry points, on the PyTorch port.

Same signatures and the same ``Q.bin`` in / ``R.bin`` + ``s.bin`` out
contract as ``XM.py`` at the repository root (the JAX package's shim):
``solve`` and ``solve_rank3`` return None, ``solve_rebuttle`` the status
int {-2, 1, 2}.  ``device``: None = the CUDA card, ``"cpu"`` for the host.
"""

from xmtpu_torch.solver import staircase as _staircase


def solve(dataset_path: str, max_rank: int = 10, tol: float = 1e-6,
          lam: float = 0.0, max_time: float = 1000.0, device=None) -> None:
    """XM main function (void return)."""
    _staircase.solve(dataset_path, max_rank, tol, lam, max_time,
                     device=device)


def solve_rebuttle(dataset_path: str, max_rank: int = 10, tol: float = 1e-6,
                   lam: float = 0.0, max_time: float = 1000.0,
                   device=None) -> int:
    """Warm-started solve, returns the status."""
    return _staircase.solve_with_init(dataset_path, max_rank, tol, lam,
                                      max_time, device=device)


def solve_rank3(dataset_path: str, max_rank: int = 10, tol: float = 1e-6,
                lam: float = 0.0, max_time: float = 1000.0,
                device=None) -> None:
    """Single rank-3 solve, no certificate."""
    _staircase.solve_rank3(dataset_path, max_rank, tol, lam, max_time,
                           device=device)
