"""State carried between ``xmtpu`` (JAX) and ``xmtpu_torch``.

The system has no weights: its "parameters" are the cost matrix and the
solver state.  These functions map them across as numpy arrays, so both
packages can run from identical state (the parity tests) and a run can move
between them.  Nothing here imports JAX: reference objects are read through
their field names (``_asdict()`` of a NamedTuple, or a plain dict) and
``np.asarray`` of each value.
"""

from __future__ import annotations

import numpy as np
import torch

from xmtpu_torch._device import resolve_device
from xmtpu_torch.ops.qop import DenseQ

_TENSOR_FIELDS = ("R", "s_ex", "QsR")
_INT_FIELDS = ("shrink_count", "endreason", "k", "total_inner", "done_reason",
               "collapse_count", "accepts_since_collapse", "outer_iters",
               "rank", "status")
_STATE_FIELDS = ("R", "s_ex", "loss", "delta", "shrink_count", "endreason",
                 "k", "total_inner", "gradnorm", "done", "done_reason")


def qop_from_numpy(C, device=None, psd_hint: bool = False) -> DenseQ:
    """A dense cost matrix (numpy or array-like, (3n, 3n)) as the port's
    float64 ``DenseQ`` on ``device`` (None = the CUDA card)."""
    dev = resolve_device(device)
    return DenseQ(torch.as_tensor(np.asarray(C), dtype=torch.float64,
                                  device=dev), psd_hint)


def _fields(x) -> dict:
    return dict(x._asdict()) if hasattr(x, "_asdict") else dict(x)


def tr_state_from_numpy(x, device=None):
    """Map the arrays of an ``xmtpu`` ``TRState``, ``TRResult`` or
    ``SolveResult`` (a NamedTuple, or a dict of its fields) into the port's
    structure of the same name, arrays on ``device`` (a ``SolveResult``
    holds host arrays, as in both packages)."""
    from xmtpu_torch.solver.staircase import SolveResult
    from xmtpu_torch.solver.trust_region import TRResult, TRState, np_dtype

    d = _fields(x)
    if "status" in d:                              # SolveResult: host arrays
        out = {f: d[f] for f in SolveResult._fields if f in d}
        out["R"], out["s_ex"] = np.asarray(d["R"]), np.asarray(d["s_ex"])
        for f in ("primal", "gap", "lam_min"):
            out[f] = float(np.asarray(d[f]))
        for f in ("rank", "status", "outer_iters", "total_inner"):
            out[f] = int(np.asarray(d[f]))
        out["certified"] = bool(np.asarray(d["certified"]))
        out["stages"] = tuple(d.get("stages", ()))
        return SolveResult(**out)

    dev = resolve_device(device)
    R = torch.as_tensor(np.array(d["R"]), device=dev)
    dt = np_dtype(R.dtype)
    out = {}
    for f, v in d.items():
        if v is None:
            out[f] = None
        elif f in _TENSOR_FIELDS:
            out[f] = torch.as_tensor(np.array(v), device=dev)
        elif f in _INT_FIELDS:
            out[f] = int(np.asarray(v))
        elif f == "done":
            out[f] = bool(np.asarray(v))
        elif f == "hist":
            out[f] = np.array(v)
        else:
            out[f] = dt(np.asarray(v))
    if "primal" in d:                              # TRResult
        out["primal"] = float(out["primal"])
        out["gradnorm"] = float(out["gradnorm"])
        return TRResult(**{f: out[f] for f in TRResult._fields if f in out})
    missing = [f for f in _STATE_FIELDS if f not in out]
    if missing:
        raise ValueError(f"tr_state_from_numpy: missing fields {missing}")
    return TRState(**{f: out[f] for f in TRState._fields if f in out})


def to_numpy(x) -> dict:
    """The reverse mapping: a port ``TRState``/``TRResult``/``SolveResult``
    as a dict of numpy values with the reference's dtypes (int32 counters,
    bool flags), ready for ``xmtpu``'s structure of the same name."""
    out = {}
    for f, v in _fields(x).items():
        if v is None:
            out[f] = None
        elif isinstance(v, torch.Tensor):
            out[f] = v.detach().cpu().numpy()
        elif f in _INT_FIELDS:
            out[f] = np.asarray(v, np.int32)
        elif f in ("done", "certified"):
            out[f] = np.asarray(v, np.bool_)
        elif f == "stages":
            out[f] = tuple(v)
        else:
            out[f] = np.asarray(v)
    return out
