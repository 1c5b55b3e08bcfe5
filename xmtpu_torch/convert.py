"""State carried between ``xmtpu`` (JAX) and ``xmtpu_torch``.

The solver has no weights: its "parameters" are the cost matrix and the
solver state.  These functions map them across as numpy arrays, so both
packages can run from identical state (the parity tests) and a run can move
between them.  Nothing here imports JAX: reference objects are read
through their field names (``_asdict()`` of a NamedTuple, or a plain dict)
and ``np.asarray`` of each value.  Implicit operators cross the same way
(:func:`schurq_from_numpy`), so a test can hold the port's ``apply`` apart
from its ``build``, and so does the one network of the pipeline, the tiny
monodepth net of ``pipeline/depth_net.py``
(:func:`depth_net_state_from_reference`).
"""

from __future__ import annotations

import dataclasses

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
    if hasattr(x, "_asdict"):
        return dict(x._asdict())
    if dataclasses.is_dataclass(x):
        return {f.name: getattr(x, f.name) for f in dataclasses.fields(x)}
    return dict(x)


def schurq_from_numpy(x, device=None, kind: "str | None" = None):
    """An ``xmtpu`` implicit operator (``SchurQ``, ``SchurQEdgeF32`` or
    ``SchurQTF``: the dataclass itself or a dict of its fields) as the
    port's operator of the same name on ``device`` (None = the CUDA card).

    Arrays are carried across as numpy (ids as int64, the CSR boundaries
    as int32); static fields (``psd_ok``, the bands) are kept and the
    reference's interpret flag is dropped.  ``kind`` names the class when
    ``x`` is a dict.  The two-float classes gain the ``bounds_l`` /
    ``bounds_f`` fields of the port, rebuilt from their sorted ids.  The
    output of the reference's ``parallel.mesh.shard_schurq`` carries across
    as it is: its phantom cameras, its zero-row-padded ``VT_inv`` and its
    edge leaves padded with the last sorted id and zero coefficients leave
    the applies unchanged (``np.asarray`` gathers each sharded array).
    """
    from xmtpu_torch.ops import schurq as sq

    cls = getattr(sq, kind or type(x).__name__)
    d = _fields(x)
    dev = resolve_device(device)
    ids = ("f_l", "l_l", "f_f", "l_f")
    if "bounds_l" not in d:
        f_f, l_l = np.asarray(d["f_f"]), np.asarray(d["l_l"])
        M, N = len(np.asarray(d["inv_q3"])), len(np.asarray(d["Q1"]))
        d["bounds_l"] = np.searchsorted(l_l, np.arange(M + 1))
        d["bounds_f"] = np.searchsorted(f_f, np.arange(N + 1))
    kw = {}
    for f in dataclasses.fields(cls):
        v = d[f.name]
        if f.name in ids:
            kw[f.name] = torch.as_tensor(np.array(v, np.int64), device=dev)
        elif f.name in ("bounds_l", "bounds_f"):
            kw[f.name] = torch.as_tensor(np.array(v, np.int32), device=dev)
        elif f.name == "psd_ok":
            kw[f.name] = bool(v)
        elif f.name in ("band_l", "band_f"):
            kw[f.name] = int(v)
        else:
            kw[f.name] = torch.as_tensor(np.array(v), device=dev)
    q = cls(**kw)
    if hasattr(x, "vt_resid_ratio"):
        q.vt_resid_ratio = float(x.vt_resid_ratio)
    return q


_OPTION_CLASSES = {
    "PositionerOptions": "xmtpu_torch.pipeline.global_positioning",
    "BundleAdjusterOptions": "xmtpu_torch.pipeline.bundle_adjustment",
    "TriangulatorOptions": "xmtpu_torch.pipeline.triangulation",
    "GravityRefinerOptions": "xmtpu_torch.pipeline.gravity",
}


def options_from_reference(x, kind: "str | None" = None):
    """An ``xmtpu`` options dataclass of the mapper's tail stages
    (``PositionerOptions``, ``BundleAdjusterOptions``,
    ``TriangulatorOptions`` or ``GravityRefinerOptions``: the dataclass
    itself, or a dict of its fields with ``kind`` naming the class) as the
    port's dataclass of the same name, field by field.  A field the port's
    class does not have raises ``ValueError``."""
    import importlib

    name = kind or type(x).__name__
    if name not in _OPTION_CLASSES:
        raise ValueError(f"options_from_reference: no port class {name!r}")
    cls = getattr(importlib.import_module(_OPTION_CLASSES[name]), name)
    d = _fields(x)
    known = {f.name for f in dataclasses.fields(cls)}
    unknown = sorted(set(d) - known)
    if unknown:
        raise ValueError(f"options_from_reference: {name} has no field "
                         f"{unknown}")
    return cls(**d)


def depth_net_state_from_reference(params) -> dict:
    """The JAX package's tiny-monodepth parameters (a dict of numpy arrays
    by the reference module's parameter names, e.g. ``body.0.weight``) as
    the port's ``state_dict`` for ``depth_net.build_net()``: float32
    tensors on the host, ready for ``load_state_dict``.  A missing or
    unknown name, or a shape other than the port's, raises ``ValueError``."""
    from xmtpu_torch.pipeline.depth_net import build_net

    want = build_net().state_dict()
    missing = sorted(set(want) - set(params))
    unknown = sorted(set(params) - set(want))
    if missing or unknown:
        raise ValueError(f"depth_net_state_from_reference: missing "
                         f"{missing}, unknown {unknown}")
    out = {}
    for name, ref in want.items():
        a = np.asarray(params[name], dtype=np.float32)
        if a.shape != tuple(ref.shape):
            raise ValueError(f"depth_net_state_from_reference: {name} has "
                             f"shape {a.shape}, expected {tuple(ref.shape)}")
        out[name] = torch.from_numpy(a.copy())
    return out


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
