"""Multi-slot sharding: camera-block row distribution over a mesh.

PyTorch counterpart of ``xmtpu/parallel/mesh.py``, with the same public
names and signatures.  The reference runs one program under GSPMD over a
1-D ``cam`` mesh; PyTorch has no GSPMD, so the pieces XLA inserts are
written out in the sharded operators of ``parallel/sharded.py`` (the
all-gather of the thin operand, the partial segment sums across slot edges,
the padding of ``VT_inv`` and of the edge arrays), and the solver and the
certificate run on them unchanged:

* dense ``C`` is row-sharded by camera block (:class:`ShardedDenseQ`); the
  factor and the scales stay whole on the mesh's lead device;
* a factored ``SchurQ`` shards its factors (:func:`shard_schurq`).

A mesh is a list of slots, each a device.  :func:`make_mesh` takes distinct
CUDA cards, or host slots (``platform="cpu"``, the counterpart of the
reference tests' virtual CPU devices); a :class:`Mesh` built from a device
list may name one device several times, which is how one card holds
several slots.  The certificate of a sharded dense operator takes the
matvec flow (the reference's own route above 3n = 4096 on an accelerator),
never the Cholesky probe on a whole ``C``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from xmtpu_torch._device import resolve_device
from xmtpu_torch.ops import manifold as mf
from xmtpu_torch.ops.qop import DenseQ, QOperator
from xmtpu_torch.ops.schurq import (SchurQ, SchurQEdgeF32, SchurQTF,
                                    pad_cameras)
from xmtpu_torch.parallel.sharded import (ShardedDenseQ, ShardedSchurQ,
                                          split_dense, split_schurq)
from xmtpu_torch.solver import trust_region as tr


class Mesh:
    """A 1-D mesh of slots.

    ``devices``: this process's slots, one device each (repeats allowed);
    ``processes`` / ``rank``: the number of processes that hold as many
    slots each, and this one's index (``parallel/distributed.py``).  Slot
    ``k`` of process ``r`` is global slot ``r * len(devices) + k``; the
    first local slot's device is the ``lead``, where the solver's carries
    live.
    """

    def __init__(self, devices, axis_names=("cam",), processes: int = 1,
                 rank: int = 0):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one slot")
        self.axis_names = tuple(axis_names)
        self.processes = processes
        self.rank = rank

    @property
    def size(self) -> int:
        """Global slot count."""
        return len(self.devices) * self.processes

    @property
    def lead(self) -> torch.device:
        return self.devices[0]


def make_mesh(n_devices: int | None = None, axis: str = "cam",
              platform: str | None = None) -> Mesh:
    """Build a 1-D mesh.  ``platform=None`` (or ``"cuda"``) takes distinct
    CUDA cards, the first ``n_devices`` of them (all by default), and
    raises ``ValueError`` with fewer; ``"cpu"`` gives ``n_devices`` host
    slots (default 1)."""
    if platform in (None, "cuda"):
        resolve_device(None)
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    elif platform == "cpu":
        devs = [torch.device("cpu")] * (n_devices or 1)
    else:
        raise ValueError(f"make_mesh: unknown platform {platform!r}")
    if n_devices is not None:
        if len(devs) < n_devices:
            raise ValueError(f"need {n_devices} devices, have {len(devs)} "
                             f"on platform {platform or 'cuda'}")
        devs = devs[:n_devices]
    return Mesh(devs, (axis,))


def _single_process(mesh: Mesh, what: str) -> None:
    if mesh.processes != 1:
        raise ValueError(f"{what} shards within one process; across "
                         f"processes use parallel.distributed")


def _dense_tensor(C):
    if isinstance(C, DenseQ):
        return C.C, C.psd_hint
    if isinstance(C, np.ndarray) and not C.flags.writeable:
        C = C.copy()
    return torch.as_tensor(C, dtype=torch.float64), False


def shard_problem(mesh: Mesh, C, R, s_ex, axis: str = "cam"):
    """Place ``(C, R, s_ex)``: ``C`` (a matrix or ``DenseQ``) row-sharded by
    camera block over the mesh's slots as a :class:`ShardedDenseQ`; ``R``
    and ``s_ex`` whole on the lead device (the thin operands the reference
    all-gathers for every GEMM)."""
    _single_process(mesh, "shard_problem")
    C, hint = _dense_tensor(C)
    Cs = split_dense(C, mesh.devices, mesh.lead, psd_hint=hint)

    def lead(x):
        x = torch.as_tensor(x, device=mesh.lead)
        return x if x.is_floating_point() else x.to(torch.float64)

    return Cs, lead(R), lead(s_ex)


def _one_outer_step(Q: QOperator, R, s_ex, lam=0.0, gradtol=1e-8):
    """One outer trust-region iteration from ``(R, s_ex)`` at the
    reference's restart radius, unpreconditioned: ``(R', s_ex', loss')``."""
    n, _, o = R.shape
    dim = n * (3 * o - 6) + n - 1
    dt = tr.np_dtype(R.dtype)
    delta_bar = dt(np.sqrt(float(dim)))
    (loss,) = tr._fetch(mf.objective(Q.apply, R, s_ex, float(lam)), dt=dt)
    st = tr.TRState(
        R=R, s_ex=s_ex, loss=loss, delta=delta_bar / dt(8.0),
        shrink_count=0, endreason=tr.ER_MAX_INNER, k=0, total_inner=0,
        gradnorm=dt(np.inf), done=False, done_reason=tr.RUNNING)
    out = tr._outer_step(tr.EagerSegments(Q.apply, dt(lam), tr.TRConfig()),
                         st, dt(gradtol), delta_bar)
    return out.R, out.s_ex, out.loss


def sharded_tr_step(mesh: Mesh, C, R, s_ex, lam=0.0, gradtol=1e-8,
                    axis: str = "cam"):
    """One outer trust-region iteration with sharded operands.

    Returns ``(R', s_ex', loss')`` (the loss a host scalar).  Used by the
    multi-slot dry run and as the building block of larger solves; the full
    solve reuses the same sharding through :func:`solve_sharded`.
    """
    Cs, R, s_ex = shard_problem(mesh, C, R, s_ex, axis)
    return _one_outer_step(Cs, R, s_ex, lam, gradtol)


def solve_sharded(mesh: Mesh, C, R0, s_ex0, lam=0.0, gradtol=1e-6,
                  cfg: tr.TRConfig = tr.TRConfig(), axis: str = "cam"):
    """Full sharded trust-region solve: the single-device solver on the
    row-sharded operator, its carries on the lead device."""
    Cs, R0, s_ex0 = shard_problem(mesh, C, R0, s_ex0, axis)
    return tr.trust_region_solve(Cs, R0, s_ex0, lam=lam, gradtol=gradtol,
                                 cfg=cfg, device=mesh.lead)


def _is_factored(Q) -> bool:
    return isinstance(Q, (SchurQ, SchurQEdgeF32, SchurQTF))


def shard_schurq(mesh: Mesh, Q, axis: str = "cam") -> ShardedSchurQ:
    """Shard a factored :class:`~xmtpu_torch.ops.schurq.SchurQ` (or its
    mixed-edge / two-float form) over the mesh's slots by the reference's
    layout:

    * per-camera leaves (``Q1``, ``V1``, their hi/lo pairs) and the rows of
      ``VT_inv`` split by camera; ``VT_inv``'s n-1 rows are zero-padded to
      the slot count (``solve_M`` slices them off).  A camera count the slot
      count does not divide is first zero-extended with phantom cameras
      (``schurq.pad_cameras``), as the reference does;
    * both sorted edge orderings split by observation, padded with the last
      sorted id and zero coefficients, each slot with its own CSR
      boundaries;
    * landmark vectors replicated.

    The reference kernel's bands are cleared (recorded only; the reference
    shards with its Pallas sums off).  The operator stays on the mesh: see
    ``parallel/sharded.py``.
    """
    if not _is_factored(Q):
        raise TypeError(f"shard_schurq: {type(Q).__name__} is not a "
                        f"factored SchurQ operator")
    _single_process(mesh, "shard_schurq")
    if getattr(Q, "band_l", 0) or getattr(Q, "band_f", 0):
        Q = dataclasses.replace(Q, band_l=0, band_f=0)
    n = Q.n_cameras
    if n % mesh.size:
        Q = pad_cameras(Q, n + (-n) % mesh.size)
    return split_schurq(Q, mesh.devices, mesh.lead)


def solve_arrays_sharded(mesh: Mesh, C, axis: str = "cam", **kwargs):
    """Full certified staircase (``solve_arrays``) with the cost operator
    sharded over the mesh: dense ``C`` row-sharded by camera block, a
    factored ``SchurQ`` sharded per :func:`shard_schurq`.  The solve runs on
    the mesh's lead device; phantom padding cameras are sliced back off the
    result."""
    from xmtpu_torch.solver.staircase import solve_arrays

    kwargs.setdefault("device", mesh.lead)
    n_orig = None
    if isinstance(C, ShardedSchurQ | ShardedDenseQ):
        Cs = C
    elif _is_factored(C):
        n_orig = C.n_cameras
        Cs = shard_schurq(mesh, C, axis)
    else:
        _single_process(mesh, "solve_arrays_sharded")
        C, hint = _dense_tensor(C)
        Cs = split_dense(C, mesh.devices, mesh.lead, psd_hint=hint)
    res = solve_arrays(Cs, **kwargs)
    if n_orig is not None and Cs.n_cameras != n_orig:
        # slice the phantom padding cameras back off (pad_cameras)
        res = res._replace(R=res.R[: 3 * n_orig], s_ex=res.s_ex[:n_orig])
    return res
