"""Cost operators sharded over the slots of a mesh.

PyTorch has no GSPMD, so what XLA inserts into the reference's sharded
programs (``xmtpu/parallel/mesh.py``) is written out here, inside the
operators; the solver and the certificate run unchanged on them, as the
reference's do ("sharding is injected through the operand shardings").

* :class:`ShardedDenseQ`: dense ``C`` in row slabs of whole camera blocks,
  one a slot.  An apply sends the thin ``Y (3n, o)`` to every slot (the
  reference's all-gather of the thin operand), runs each slab's GEMM there
  and brings the rows back to the lead device in slot order; across
  processes (``parallel/distributed.py``) the rows of every process are then
  all-gathered, so each rank holds the same product.
* :class:`ShardedSchurQ`: a ``SchurQ`` (or its ``edge_f32`` / ``two_float``
  form) with the reference's camera layout (``shard_schurq``): the camera
  leaves (``Q1``, ``V1`` and their hi/lo pairs) split by camera, ``VT_inv``'s
  rows zero-padded to the slot count and split in row panels, the landmark
  vectors replicated.  Each sorted edge ordering is cut near every ``k E /
  S``, at the start of the segment holding that offset, so every segment
  lies whole in one slot (slots differ by at most one segment's rows).  It
  runs the stage code of ``ops/schurq.py`` through its own seams: ``_cam``
  on each slot's cameras, ``_vt`` on each panel, and ``_esum``, which sums
  each slot's edge rows with ONE ``sorted_segment_sum`` over the slot's own
  CSR boundaries and writes the sums into the slot's run of segments: every
  segment is added in row order from zero, as on one device, so the sums
  have the single-device bits on every run.

The tCG carries (factor, scales, tangents, residuals) stay whole on the
lead device: they are O(n o) against ``C``'s O(n^2), and GSPMD gathers them
for every GEMM anyway.  A sharded operator exposes no whole ``C``, so the
dense fused variant ``tcg_step_dense`` is never chosen for it
(``fused_tcg.dense_matrix``), and the certificate takes its matvec flow.
Neither operator gathers itself onto one device: :meth:`to` accepts only
its lead device, and :meth:`cast` casts slot by slot.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from xmtpu_torch.ops.qop import QOperator
from xmtpu_torch.ops.schurq import SchurQ, SchurQEdgeF32
from xmtpu_torch.ops.segsum import sorted_segment_sum


def _same_device(a, b) -> bool:
    """``a`` and ``b`` name the same device (an unindexed ``cuda`` is the
    current card)."""
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    cur = torch.cuda.current_device()
    return (cur if a.index is None else a.index) == (
        cur if b.index is None else b.index)


def _stay_on(lead, device, what: str) -> None:
    if not _same_device(device, lead):
        raise ValueError(f"{what} lives on its mesh (lead device {lead}); "
                         f"solve it there, not on {device}: moving it would "
                         f"gather it onto one device")


def all_gather_rows(t: torch.Tensor) -> torch.Tensor:
    """Every process's ``t`` (equal shapes) stacked in rank order along
    dim 0, through the list form of ``torch.distributed.all_gather`` (the
    form gloo takes for CUDA tensors too)."""
    import torch.distributed as dist

    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t.contiguous())
    return torch.cat(parts)


class ShardedDenseQ(QOperator):
    """Dense ``C`` as row slabs of whole camera blocks.

    ``slabs``: this process's slabs, slab ``k`` on its slot's device, in
    row order; ``diag``: every camera's (3, 3) diagonal block on ``lead``
    (the block-Jacobi preconditioner's input); ``processes``: the number of
    processes whose slabs make up ``C`` (each holds as many rows), whose
    rows an apply all-gathers.
    """

    dense_rows = True

    def __init__(self, slabs, lead, diag, psd_hint: bool = False,
                 processes: int = 1):
        self.slabs = list(slabs)
        self.lead = torch.device(lead)
        self.diag = diag
        self.psd_hint = psd_hint
        self.processes = processes

    @classmethod
    def from_slabs(cls, slabs, row0, lead, psd_hint: bool = False,
                   processes: int = 1) -> "ShardedDenseQ":
        """The operator of ``slabs`` whose first rows are ``row0`` (global
        rows, multiples of 3), its diagonal blocks read from the slabs."""
        blocks = []
        for s, r0 in zip(slabs, row0):
            nc, c0, N = s.shape[0] // 3, r0 // 3, s.shape[1] // 3
            d = torch.diagonal(s.view(nc, 3, N, 3)[:, :, c0:c0 + nc, :],
                               dim1=0, dim2=2).permute(2, 0, 1)
            blocks.append(d.to(lead))
        diag = torch.cat(blocks)
        if processes > 1:
            diag = all_gather_rows(diag)
        return cls(slabs, lead, diag, psd_hint, processes)

    @property
    def dim(self) -> int:
        return 3 * self.diag.shape[0]

    @property
    def shape(self) -> tuple:
        return (self.dim, self.dim)

    @property
    def device(self) -> torch.device:
        return self.lead

    @property
    def psd_by_construction(self) -> bool:
        return self.psd_hint

    def apply(self, Y: torch.Tensor) -> torch.Tensor:
        rows = [(s @ Y.to(s.device)).to(self.lead) for s in self.slabs]
        out = torch.cat(rows) if len(rows) > 1 else rows[0]
        if self.processes > 1:
            out = all_gather_rows(out)
        return out

    def diag_blocks(self):
        return self.diag

    def slab_bytes(self) -> list:
        return [s.numel() * s.element_size() for s in self.slabs]

    def cast(self, dtype) -> "ShardedDenseQ":
        return ShardedDenseQ([s.to(dtype) for s in self.slabs], self.lead,
                             self.diag.to(dtype),
                             self.psd_hint and dtype == torch.float64,
                             self.processes)

    def to(self, device) -> "ShardedDenseQ":
        _stay_on(self.lead, device, "a sharded dense operator")
        return self


def split_dense(C, devices, lead, psd_hint: bool = False) -> ShardedDenseQ:
    """Row-shard a dense (3n, 3n) ``C`` by camera block over ``devices``
    (one slab a device entry, repeats allowed): the cameras are cut into
    ``len(devices)`` contiguous runs of sizes differing by at most one."""
    n, S = C.shape[0] // 3, len(devices)
    if n < S:
        raise ValueError(f"{n} cameras cannot fill {S} slots")
    cuts = [3 * int(c[0]) for c in np.array_split(np.arange(n), S)]
    bounds = cuts + [3 * n]
    slabs = [C[a:b].to(dev, torch.float64).contiguous()
             for a, b, dev in zip(bounds[:-1], bounds[1:], devices)]
    return ShardedDenseQ.from_slabs(slabs, cuts, lead, psd_hint)


# ---- the factored operator ------------------------------------------------

# the fields of the SchurQ family by layout (the reference's specs)
_CAMERA = ("Q1", "V1", "q1h", "q1l", "v1h", "v1l")
_VT = ("VT_inv", "vth", "vtl")
_LANDMARK = ("inv_q3", "inv_sqrt_q3")
_EDGES = {"l": ("f_l", "l_l", "wx_l", "cf_l", "wxh_l", "wxl_l", "cfh_l",
                "cfl_l"),
          "f": ("f_f", "l_f", "wx_f", "cf_f", "wxh_f", "wxl_f", "cfh_f",
                "cfl_f")}
_BOUNDS = {"l": "bounds_l", "f": "bounds_f"}
_SEG_IDS = {"l": "l_l", "f": "f_f"}


@dataclass
class _Slot:
    """One slot's piece: ``q`` is an operator of the sharded one's class
    holding the slot's cameras, its ``VT_inv`` rows, its run of each edge
    ordering (with their CSR boundaries in ``bounds_l`` / ``bounds_f``,
    local to the slot) and the replicated landmark vectors; ``ids`` are the
    local segment ids of each ordering, ``segs`` its first segment and
    segment count."""
    q: QOperator
    dev: torch.device
    cams: tuple
    ids: dict
    segs: dict


class ShardedSchurQ(QOperator):
    """A ``SchurQ`` / ``SchurQEdgeF32`` / ``SchurQTF`` sharded over slots
    (module doc); its stage code is that class's, run through the seams
    below.  ``stats["slot_sums"]`` counts each slot's segment sums, shared
    with the operator's casts and derived forms."""

    def __init__(self, slots, lead, inv_q3, inv_sqrt_q3,
                 stats: "dict | None" = None):
        self.slots = list(slots)
        self.lead = torch.device(lead)
        self.inv_q3 = inv_q3
        self.inv_sqrt_q3 = inv_sqrt_q3
        self.stats = stats if stats is not None else {
            "slot_sums": [0] * len(self.slots)}

    @property
    def kind(self):
        """The class of the operator this one shards."""
        return type(self.slots[0].q)

    @property
    def n_cameras(self) -> int:
        return self.slots[-1].cams[1]

    @property
    def n_landmarks(self) -> int:
        return self.inv_q3.shape[0]

    @property
    def dim(self) -> int:
        return 3 * self.n_cameras

    @property
    def device(self) -> torch.device:
        return self.lead

    @property
    def psd_by_construction(self) -> bool:
        return self.slots[0].q.psd_by_construction

    def diag_blocks(self):
        return torch.cat([s.q.Q1.to(self.lead) for s in self.slots])

    # ---- the seams of ops/schurq.py, slot by slot ----

    def _cam(self, fn, *xs):
        outs = []
        for s in self.slots:
            c0, c1 = s.cams
            args = [x[c0:c1].to(s.dev) if isinstance(x, torch.Tensor) else x
                    for x in xs]
            outs.append(fn(s.q, *args).to(self.lead))
        return torch.cat(outs)

    def _vt(self, rhs):
        return torch.cat([s.q._vt(rhs.to(s.dev)).to(self.lead)
                          for s in self.slots])

    def _esum(self, order: str, fn, *xs):
        num = self.n_landmarks if order == "l" else self.n_cameras
        out = None
        for k, s in enumerate(self.slots):
            first, count = s.segs[order]
            if not count:
                continue            # a slot without rows of this ordering
            rows = fn(s.q, *[x.to(s.dev) for x in xs])
            part = sorted_segment_sum(
                rows.reshape(rows.shape[0], -1).contiguous(), s.ids[order],
                count, offsets=getattr(s.q, _BOUNDS[order]))
            self.stats["slot_sums"][k] += 1
            if out is None:
                out = part.new_zeros((num, part.shape[1]), device=self.lead)
            out[first:first + count] = part.to(self.lead)
        return out.reshape((num,) + tuple(rows.shape[1:]))

    # ---- the stage code of the sharded class ----

    def _esum2(self, order: str, fn, *xs):
        return SchurQEdgeF32._esum2(self, order, fn, *xs)

    def _vtpT(self, Yb):
        return self.kind._vtpT(self, Yb)

    def _vtp(self, z_A, z_B):
        return self.kind._vtp(self, z_A, z_B)

    def _v3f(self, z_B):
        return self.kind._v3f(self, z_B)

    def _v3fT(self, x_A):
        return self.kind._v3fT(self, x_A)

    def solve_M(self, b_A, b_B):
        return self.kind.solve_M(self, b_A, b_B)

    @property
    def apply_span(self):
        return self.kind.apply_span

    def apply(self, Y: torch.Tensor) -> torch.Tensor:
        return self.kind.apply(self, Y)

    def recover_y(self, sR: torch.Tensor) -> torch.Tensor:
        return self.kind.recover_y(self, sR)

    # ---- derived forms, casts, moves ----

    def _derive(self, fn, landmarks=lambda v: v) -> "ShardedSchurQ":
        """``fn`` applied to every slot's piece (``landmarks`` to the lead's
        landmark vectors); the split and the stats are shared."""
        slots = [dataclasses.replace(s, q=fn(s.q)) for s in self.slots]
        return ShardedSchurQ(slots, self.lead,
                             landmarks(self.inv_q3),
                             landmarks(self.inv_sqrt_q3), self.stats)

    def edge_f32(self, pallas: "bool | None" = None) -> "ShardedSchurQ":
        """The sharded mixed-edge form, derived slot by slot (bands stay
        0: the reference shards with its Pallas sums off)."""
        if self.kind is not SchurQ:
            raise TypeError(f"edge_f32 of a sharded {self.kind.__name__}")
        return self._derive(lambda q: q.edge_f32())

    def two_float(self, pallas: "bool | None" = None) -> "ShardedSchurQ":
        """The sharded two-float form, derived slot by slot."""
        if self.kind is not SchurQ:
            raise TypeError(f"two_float of a sharded {self.kind.__name__}")
        return self._derive(lambda q: q.two_float())

    def cast(self, dtype) -> "ShardedSchurQ":
        return self._derive(lambda q: q.cast(dtype), lambda v: v.to(dtype))

    def to(self, device) -> "ShardedSchurQ":
        _stay_on(self.lead, device, "a sharded SchurQ")
        return self


def split_schurq(Q, devices, lead) -> ShardedSchurQ:
    """Shard ``Q`` (its camera count a multiple of ``len(devices)``: see
    ``schurq.pad_cameras``) over ``devices`` (repeats allowed) by the
    layout of the module doc."""
    S = len(devices)
    n = Q.n_cameras
    E = Q.f_l.shape[0]
    if n % S or E < S:
        raise ValueError(f"{n} cameras / {E} observations over {S} slots")
    vals = {f.name: getattr(Q, f.name) for f in dataclasses.fields(Q)
            if isinstance(getattr(Q, f.name), torch.Tensor)}
    known = set(_CAMERA + _VT + _LANDMARK + _EDGES["l"] + _EDGES["f"]
                + tuple(_BOUNDS.values()))
    unknown = sorted(set(vals) - known)
    if unknown:
        raise ValueError(f"no sharding rule for the fields {unknown}")
    # VT_inv's rows: zero-padded to the slot count (solve_M slices them off)
    for name in _VT:
        if name in vals:
            v = vals[name]
            vals[name] = torch.nn.functional.pad(
                v, (0, 0, 0, (-v.shape[0]) % S))
    per_c = n // S
    # each ordering's cuts: the start of the segment holding k E / S
    seg_ids, cuts = {}, {}
    for o in ("l", "f"):
        sid = seg_ids[o] = vals[_SEG_IDS[o]].cpu().numpy()
        at = sid[np.arange(S) * E // S]
        cuts[o] = np.append(np.searchsorted(sid, at), E)

    slots = []
    for k, dev in enumerate(devices):
        upd, ids, segs = {}, {}, {}
        for name, v in vals.items():
            if name in _CAMERA:
                upd[name] = v[k * per_c:(k + 1) * per_c].to(dev)
            elif name in _VT:
                rows = v.shape[0] // S
                upd[name] = v[k * rows:(k + 1) * rows].to(dev)
            elif name in _LANDMARK:
                upd[name] = v.to(dev)
        for o in ("l", "f"):
            e0, e1 = int(cuts[o][k]), int(cuts[o][k + 1])
            for name in _EDGES[o]:
                if name in vals:
                    upd[name] = vals[name][e0:e1].to(dev)
            sid = seg_ids[o][e0:e1]
            lo = int(sid[0]) if e1 > e0 else 0
            cnt = int(sid[-1]) - lo + 1 if e1 > e0 else 0
            local = sid - lo
            upd[_BOUNDS[o]] = torch.as_tensor(
                np.searchsorted(local, np.arange(cnt + 1)).astype(np.int32),
                device=dev)
            ids[o] = torch.as_tensor(local, dtype=torch.int64, device=dev)
            segs[o] = (lo, cnt)
        slots.append(_Slot(dataclasses.replace(Q, **upd), torch.device(dev),
                           (k * per_c, (k + 1) * per_c), ids, segs))
    return ShardedSchurQ(slots, lead, Q.inv_q3.to(lead),
                         Q.inv_sqrt_q3.to(lead))
