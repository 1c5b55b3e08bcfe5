"""Solver-state checkpoint/resume.

Counterpart of ``xmtpu/solver/checkpoint.py``: the same two ``.npz``
layouts, so a checkpoint written by either package resumes in the other.

* ``StaircaseCheckpoint``: the staircase position between ranks (factor,
  scales, rank, tightened tolerance, pending escape direction).
* ``TRCheckpoint``: the full trust-region state at a chunk boundary, for a
  resume inside a rank.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np
import torch


class StaircaseCheckpoint(NamedTuple):
    R: np.ndarray          # (n, 3, o) current factor
    s_ex: np.ndarray       # (n,)
    rank: int
    gradtol: float         # current (possibly /10-tightened) tolerance
    escape_dir: Optional[np.ndarray]   # (3n,) pending escape direction or None
    lam: float


def save_checkpoint(path: str, ckpt: StaircaseCheckpoint) -> None:
    np.savez(
        path,
        R=ckpt.R, s_ex=ckpt.s_ex, rank=ckpt.rank, gradtol=ckpt.gradtol,
        escape_dir=(ckpt.escape_dir if ckpt.escape_dir is not None
                    else np.zeros(0)),
        lam=ckpt.lam,
    )


def load_checkpoint(path: str) -> "StaircaseCheckpoint | TRCheckpoint":
    """Load either checkpoint kind (between-rank or mid-stage)."""
    z = np.load(path)
    if "kind" in z and str(z["kind"]) == "tr_mid":
        return _tr_from_npz(z)
    esc = z["escape_dir"]
    return StaircaseCheckpoint(
        R=z["R"], s_ex=z["s_ex"], rank=int(z["rank"]),
        gradtol=float(z["gradtol"]),
        escape_dir=None if esc.size == 0 else esc,
        lam=float(z["lam"]),
    )


class TRCheckpoint(NamedTuple):
    """Mid-stage checkpoint: every ``TRState`` field (``state_arrays``), the
    outer iterations completed, and the stage context."""

    state_arrays: dict
    k_done: int
    rank: int
    gradtol: float
    lam: float


_TR_FIELDS = ("R", "s_ex", "loss", "delta", "shrink_count", "endreason",
              "k", "total_inner", "gradnorm", "done", "done_reason",
              "QsR", "collapse_count", "accepts_since_collapse", "hist")
# the reference stores these TRState fields as int32 / bool scalars
_INT_FIELDS = ("shrink_count", "endreason", "k", "total_inner", "done_reason",
               "collapse_count", "accepts_since_collapse")


def _to_numpy(field: str, v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    if field in _INT_FIELDS:
        return np.asarray(v, np.int32)
    if field == "done":
        return np.asarray(v, np.bool_)
    return np.asarray(v)


def save_tr_checkpoint(path: str, state, k_done: int, rank: int,
                       gradtol: float, lam: float) -> None:
    """Serialize a ``trust_region.TRState`` at a chunk boundary; write then
    rename, so a kill mid-write never corrupts the previous checkpoint."""
    fields = [f for f in _TR_FIELDS if getattr(state, f) is not None]
    tmp = path + ".tmp.npz"
    np.savez(tmp, kind="tr_mid", k_done=k_done, rank=rank, gradtol=gradtol,
             lam=lam, **{f"st_{f}": _to_numpy(f, getattr(state, f))
                         for f in fields})
    os.replace(tmp, path)


def _tr_from_npz(z) -> TRCheckpoint:
    return TRCheckpoint(
        state_arrays={f: z[f"st_{f}"] for f in _TR_FIELDS if f"st_{f}" in z},
        k_done=int(z["k_done"]), rank=int(z["rank"]),
        gradtol=float(z["gradtol"]), lam=float(z["lam"]))


def tr_state_from_checkpoint(ck: TRCheckpoint, Q=None, lam: float = 0.0,
                             device=None):
    """Rebuild a ``TRState`` from a mid-stage checkpoint, arrays on
    ``device`` (None = the CUDA card).  For files without ``QsR``, pass the
    stage operator ``Q`` to recompute it (one matvec)."""
    from xmtpu_torch.convert import tr_state_from_numpy
    from xmtpu_torch.ops import manifold as mf
    from xmtpu_torch.ops.qop import as_qop

    st = tr_state_from_numpy(ck.state_arrays, device=device)
    if st.QsR is None and Q is not None:
        sR = mf.flatten(mf.scale_blocks(st.R, st.s_ex))
        st = st._replace(QsR=mf.unflatten(
            2.0 * as_qop(Q, device=st.R.device).apply(sR)))
    return st
